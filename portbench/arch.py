"""The architecture of a configuration file, in plain Python: the benchmark's
own reading of the published network, shared by the weights it makes, the
plain reference and the roofline arithmetic. Nothing here imports torch or
the measured program.

Names follow the layer paths of the published ResNet (and of the measured
program's models): ``conv1``/``bn1`` (the stem), ``layer<s>.<b>.conv<u>``,
``layer<s>.<b>.bn<u>``, ``layer<s>.<b>.downsample.1`` (the shortcut's 1x1
conv after its average pool) and ``.downsample.2`` (its norm), ``fc``.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Iterator, List

ROOT = Path(__file__).resolve().parent


def load_config(name: str) -> dict:
    """``configs/<name>.json``."""
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def blocks(config: dict) -> Iterator[dict]:
    """Every residual block in forward order: its prefix, input and output
    channels, stride, whether it has a projection shortcut, and its conv
    units ``(cin, cout, k, stride)``."""
    bottleneck = config["block"] == "bottleneck"
    expansion = 4 if bottleneck else 1
    cin = config["stem_width"]
    for s, (planes, count) in enumerate(zip(config["widths"], config["layers"]), 1):
        cout = planes * expansion
        for b in range(count):
            stride = 2 if (s > 1 and b == 0) else 1
            if bottleneck:
                units = [(cin, planes, 1, 1), (planes, planes, 3, stride),
                         (planes, cout, 1, 1)]
            else:
                units = [(cin, planes, 3, stride), (planes, planes, 3, 1)]
            yield {"prefix": f"layer{s}.{b}.", "stage": s, "cin": cin, "cout": cout,
                   "stride": stride, "downsample": stride != 1 or cin != cout,
                   "units": units}
            cin = cout


def conv_layers(config: dict) -> List[dict]:
    """Every conv and dense layer in forward order, with its spatial sizes
    and its multiply-accumulates per image. ``kind`` is ``float`` for the
    first and last layers (the flagship recipe leaves them float) and
    ``binary`` for the rest. A shortcut's 1x1 conv reads the pooled map."""
    size = config["image_size"]
    stem = config["stem_width"]
    out = []

    def add(name, kind, cin, cout, k, stride, pad, h, stage=0):
        ho = _out(h, k, stride, pad)
        out.append({"name": name, "kind": kind, "cin": cin, "cout": cout, "k": k,
                    "stride": stride, "pad": pad, "h_in": h, "h_out": ho,
                    "stage": stage, "macs": ho * ho * cout * cin * k * k})
        return ho

    h = add("conv1", "float", config["in_channels"], stem, 7, 2, 3, size)
    h = _out(h, 3, 2, 1)  # the stem's max pool
    for blk in blocks(config):
        p, s = blk["prefix"], blk["stage"]
        if blk["downsample"]:
            pooled = math.ceil(h / blk["stride"])
            add(p + "downsample.1", "binary", blk["cin"], blk["cout"], 1, 1, 0,
                pooled, s)
        hh = h
        for u, (ci, co, k, st) in enumerate(blk["units"], 1):
            hh = add(f"{p}conv{u}", "binary", ci, co, k, st, k // 2, hh, s)
        h = hh
    last = out[-1]["cout"]
    out.append({"name": "fc", "kind": "float", "cin": last,
                "cout": config["num_classes"], "k": 1, "stride": 1, "pad": 0,
                "h_in": 1, "h_out": 1, "stage": len(config["layers"]),
                "macs": last * config["num_classes"]})
    return out


def state_spec(config: dict) -> List[tuple]:
    """``(name, shape, init)`` of every tensor in the QAT model's state, in
    a fixed order. ``init`` names the rule :mod:`portbench.weights` draws it
    by."""
    spec = []

    def norm(prefix, c):
        spec.extend([(prefix + ".weight", (c,), "bn_weight"),
                     (prefix + ".bias", (c,), "bn_bias"),
                     (prefix + ".running_mean", (c,), "bn_mean"),
                     (prefix + ".running_var", (c,), "bn_var"),
                     (prefix + ".num_batches_tracked", (), "count")])

    def binary(name, cin, cout, k):
        spec.append((name + ".weight", (cout, cin, k, k), "conv"))
        spec.append((name + ".activation_post_process.alpha", (1, cout, 1, 1),
                     "alpha"))

    stem = config["stem_width"]
    spec.append(("conv1.weight", (stem, config["in_channels"], 7, 7), "conv"))
    norm("bn1", stem)
    for blk in blocks(config):
        p = blk["prefix"]
        for u, (ci, co, k, _) in enumerate(blk["units"], 1):
            binary(f"{p}conv{u}", ci, co, k)
            norm(f"{p}bn{u}", co)
        if blk["downsample"]:
            binary(p + "downsample.1", blk["cin"], blk["cout"], 1)
            norm(p + "downsample.2", blk["cout"])
    last = list(blocks(config))[-1]["cout"]
    spec.append(("fc.weight", (config["num_classes"], last), "linear"))
    spec.append(("fc.bias", (config["num_classes"],), "linear"))
    return spec


def fan_in(spec_by_name: Dict[str, tuple], name: str) -> int:
    """The fan-in of the dense layer a ``linear`` tensor belongs to."""
    return spec_by_name[name.rsplit(".", 1)[0] + ".weight"][1]
