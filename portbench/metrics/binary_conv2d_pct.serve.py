"""The share, in percent, of a request's binary convs in the deployed conv
mode that run as one ``bnn_tpu_torch::binary_conv2d`` call: those calls over
them plus the ``aten::im2col`` calls (every ``F.unfold`` of a patch matrix
makes one), from the profiled slice's host events. None where the slice has
neither."""
from portbench.trace import PORT_OPS

UNIT = "%"
KERNEL_CALL = PORT_OPS + "binary_conv2d"
UNFOLD = "aten::im2col"


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    names = [n for n, _, _ in rec.trace.host]
    kernel, unfold = names.count(KERNEL_CALL), names.count(UNFOLD)
    if kernel + unfold == 0:
        return None
    return 100 * kernel / (kernel + unfold)
