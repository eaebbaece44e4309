"""Drives the toy family through a copy of the harness on the CPU, from the
copy's root: a run of each toy cell untraced and traced, every reader on a
made-up trace of the toy's kernel calls, and the control's readings. Prints
one JSON line of what it found."""
import contextlib
import io
import json
import sys
import time
from types import SimpleNamespace

import torch

import bnn_tpu_torch as bt
from tinybnn_model import TinyBNN

bt.models.tinybnn = TinyBNN

from portbench import arch, control, run  # noqa: E402
from portbench.core import Context, Record, load_cell  # noqa: E402
from portbench.trace import Trace  # noqa: E402

CELLS = ("tinybnn-serve-b4", "tinybnn-train-b8")
out = {"harness": str(arch.ROOT), "runs": {}, "readers": {}, "control": {}}
for cell in CELLS:
    for trace in (0, 1):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run.main(["--workload", cell, "--seed", str(2**31 + 7), "--seconds", "0.3",
                           "--trace", str(trace)], device="cpu")
        line = buf.getvalue().strip().splitlines()[-1] if rc == 0 else None
        out["runs"][f"{cell}/{trace}"] = {"rc": rc, "result": json.loads(line) if line else None}

# every reader on a record of the serving cell whose trace holds one device
# event a call of each of the port's kernels, at the toy's layer shapes
config = load_cell(CELLS[0])["config"]
layers = [l for l in arch.conv_layers(config) if l["kind"] == "binary"]
calls = [("binary_conv2d", [[4, l["h_in"], l["h_in"], l["cin"]], [l["cout"], l["cin"], 3, 3]])
         for l in layers]
calls += [("binary_gemm", [[4 * l["h_out"] ** 2, 9 * l["cin"]], [9 * l["cin"] // 32, l["cout"]]])
          for l in layers]
calls += [("fused_basic_block", [[4, 8, 8, 16]]), ("fused_downsample_block", [[4, 16, 16, 16]])]
kernels = [(f"void {name}_kernel<int>(Params)", 10.0 * i, 10.0 * i + 5)
           for i, (name, _) in enumerate(calls)]
trace = Trace(kernels, [("bnn_tpu_torch::binary_conv2d", 0.0, 5.0)], 0.0, 10.0 * len(calls),
              units=1, slices=1, whole=True, calls=calls)
for kind in ("serve", "train"):
    rec = Record(kind, config, {}, 4, window={"seconds": 1.0, "units": 1, "images": 4,
                                              "call_s": [0.001], "latency_s": [0.002]})
    rec.trace = trace
    for name, mod in run.readers().items():
        value = mod.read(rec)
        out["readers"][f"{kind}/{name}"] = None if value is None else float(value)

for cell in CELLS:
    ctx = Context(load_cell(cell), 5, 0.3, False, torch.device("cpu"), time.perf_counter(), 0.0)
    read = control.serve_readings if "serve" in cell else control.train_readings
    got = read(ctx)
    out["control"][cell] = {"program": got["program"], "control": got["control"],
                            "limits": ctx.cell["limits"]}
print(json.dumps(out))
