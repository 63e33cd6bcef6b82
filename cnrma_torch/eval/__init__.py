"""Detection scoring of the port (a copy of the JAX package's numpy mAP
on the torch IoU)."""
