"""One module a kind of timed call, found by the ``entry`` of a workload
file."""
