"""Device milliseconds a training step outside convolution and
matrix-product kernels (norms, the straight-through signs, casts, AdamW),
over the profiled slice; the kernel-name patterns are ``portbench.trace``'s."""
from portbench.trace import is_matmul

UNIT = "ms"


def read(rec):
    if rec.kind != "train" or rec.trace is None or not rec.trace.kernels:
        return None
    seconds, _ = rec.trace.kernel_s(lambda n: not is_matmul(n))
    return 1e3 * seconds / rec.trace.units
