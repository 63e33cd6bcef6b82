"""Configs, the registry and the model / dataset builder of the port."""
