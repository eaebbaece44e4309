"""Device milliseconds a request in kernels that are not the port's own hand
kernels (copies, casts, im2col, ``torch._int_mm``, cuDNN), over the
profiled slice."""
from portbench.trace import port_kernel

UNIT = "ms"


def read(rec):
    if rec.kind != "serve" or rec.trace is None or not rec.trace.kernels:
        return None
    seconds, _ = rec.trace.kernel_s(lambda n: port_kernel(n) is None)
    return 1e3 * seconds / rec.trace.units
