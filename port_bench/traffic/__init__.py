"""The traffic generator (``rooms.py``) and the mixes it reads
(``*.json``)."""
