"""The data preparation of the port: ``python -m
cnrma_torch.tools.data_prepare.<name>``, one module for each of the JAX
package's ``tools/data_prepare/*.py``, on the port's own modules."""
