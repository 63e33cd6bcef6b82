"""Model modules of the port (``nn.Module``s)."""
