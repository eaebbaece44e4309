"""The reader of ``binary_conv2d_pct.serve`` on hand-built traces: the share
of kernel calls among kernel calls and unfolds, 0 with unfolds only, and
None with neither or outside a serving cell."""
from types import SimpleNamespace

import pytest

from portbench import run
from portbench.trace import Trace

READ = run.readers()["binary_conv2d_pct.serve"].read
CONV, UNFOLD = "bnn_tpu_torch::binary_conv2d", "aten::im2col"


def _rec(names, kind="serve"):
    # host events one after another, and one kernel on the device
    host = [(n, 10.0 * i, 10.0 * i + 5) for i, n in enumerate(names)]
    trace = Trace([("k", 0.0, 1.0)], host, 0.0, 10.0 * len(names) + 10, units=2,
                  slices=1, whole=True)
    return SimpleNamespace(kind=kind, trace=trace)


OTHER = ["aten::select", "bnn_tpu_torch::binary_gemm", "bnn_tpu_torch::binary_conv2d_s1",
         "aten::im2col_backward", "cudaLaunchKernel"]


def test_share_of_kernel_calls():
    rec = _rec([CONV] * 6 + [UNFOLD] * 2 + OTHER)
    assert READ(rec) == pytest.approx(75.0)


def test_unfolds_only_read_zero():
    assert READ(_rec([UNFOLD] * 52 + OTHER)) == 0.0


@pytest.mark.parametrize("names,kind", [(OTHER, "serve"), ([CONV, UNFOLD], "train")])
def test_nothing_to_read(names, kind):
    assert READ(_rec(names, kind)) is None
    assert READ(SimpleNamespace(kind="serve", trace=None)) is None
