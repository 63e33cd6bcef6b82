"""Probe tools of the port: ``python -m cnrma_torch.tools.<name>``."""
