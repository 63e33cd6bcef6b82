"""One reader a per-layer metric, found by the metric's name: the file
``<name with dots as underscores>.py`` defines ``MOVES``, ``WORKLOADS``
and ``read(run)``, which returns the number or None where the run holds
nothing to read."""
