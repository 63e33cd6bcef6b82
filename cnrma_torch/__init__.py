"""PyTorch port of CN-RMA for NVIDIA GPUs (the JAX package ``cnrma_tpu``
is the reference it is held against)."""
