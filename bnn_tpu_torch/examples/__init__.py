"""Entry points of the port (counterparts of the JAX package's ``examples/``),
run as ``python -m bnn_tpu_torch.examples.<name>``."""
