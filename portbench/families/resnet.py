"""The binary ResNet family (basic and bottleneck blocks): its layer table,
its state, and the parts of the correctness checks that know its structure.

Names follow the layer paths of the published ResNet (and of the measured
program's models): ``conv1``/``bn1`` (the stem), ``layer<s>.<b>.conv<u>``,
``layer<s>.<b>.bn<u>``, ``layer<s>.<b>.downsample.1`` (the shortcut's 1x1
conv after its average pool) and ``.downsample.2`` (its norm), ``fc``.

A configuration gives ``block`` (``basic`` or ``bottleneck``),
``stem_width``, ``widths`` and ``layers`` (each stage's planes and blocks).
The structure imports nothing; the check's parts import torch when called,
so that the arithmetic stays free of it.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterator, List

ARCHS = ("resnet18", "resnet34", "resnet50")
REFERENCE = "resnet"
# every tensor of the state takes one of the shared rules of portbench.weights
INITS: Dict[str, tuple] = {}


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


# the program's kernels that compute a whole basic block in one call, and
# whether that block has its projection shortcut
FUSED_BLOCKS = {"fused_basic_block": False, "fused_downsample_block": True}


def fused_blocks(config: dict, kernel: str):
    """The blocks ``kernel`` computes in one call each, in forward order, as
    ``(layers, first unit, last unit)`` from :func:`conv_layers`; None for
    another kernel or a bottleneck network (the program fuses basic blocks
    only)."""
    if kernel not in FUSED_BLOCKS or config["block"] != "basic":
        return None
    layers = conv_layers(config)
    out = []
    for blk in blocks(config):
        if blk["downsample"] != FUSED_BLOCKS[kernel]:
            continue
        p = blk["prefix"]
        mine = {l["name"]: l for l in layers if l["name"].startswith(p)}
        out.append((list(mine.values()), mine[p + "conv1"],
                    mine[f"{p}conv{len(blk['units'])}"]))
    return out


# --- the serving check (portbench.traffic.serve_closed) ---

_PUBLISHED = re.compile(r"^(layer\d+|\d+|conv\d+|downsample)$")


def published_name(name: str) -> str:
    """A served module's path with the program's wrapper segments dropped
    (``layer2.stage.0.block.conv1`` is ``layer2.0.conv1``)."""
    return ".".join(p for p in name.split(".") if _PUBLISHED.match(p))


def watched_names(config: dict) -> set:
    """Stages (``layer<s>``), blocks (``layer<s>.<j>``) and binary layers
    (``layer<s>.<j>.conv<u>``, ``.downsample.1``) of the configuration: the
    modules whose input and output the serving check keeps."""
    names = {f"layer{s}" for s in range(1, len(config["layers"]) + 1)}
    names |= {blk["prefix"][:-1] for blk in blocks(config)}
    names |= {l["name"] for l in conv_layers(config) if l["kind"] == "binary"}
    return names


# a bound on what rounding in the serving dtype moves a value that decides a
# sign inside a block: two bf16 ulps of the larger of its two terms
SIGN_ROUNDING = 2.0 ** -7


def flip_allowance(f, blk: dict, h):
    """Per output element of the block ``blk`` on its input ``h``, the most
    that sign flips inside the block can move it: the block's convs after
    the first read the sign of the previous unit's ReLU output, so a value
    ``u = scale * acc + add`` there (``acc`` the integer sum of the signs,
    ``scale`` and ``add`` the binary conv's scales and norm folded) whose
    size is within ``SIGN_ROUNDING`` of its terms, plus what flips before it
    may move it, can read 0 or 1 on either side; each such input moves the
    next conv's integer sum by at most 1. Works the block out again from the
    reference's state ``f.S``, in the reference's own terms."""
    import torch
    import torch.nn.functional as F

    from ..reference.common import EPS

    S, p = f.S, blk["prefix"]
    t, unsure, allow = h, None, None
    for u, (_, _, k, st) in enumerate(blk["units"], 1):
        name, norm = f"{p}conv{u}", f"{p}bn{u}"
        w = S[name + ".weight"]
        inv = torch.rsqrt(S[norm + ".running_var"] + EPS) * S[norm + ".weight"]
        scale = (w.abs().mean(dim=(1, 2, 3)) * inv).view(1, -1, 1, 1) * \
            S[name + ".activation_post_process.alpha"]
        add = (S[norm + ".bias"] - S[norm + ".running_mean"] * inv).view(1, -1, 1, 1)
        acc = F.conv2d(torch.sign(t), torch.sign(w), None, st, k // 2)
        allow = torch.zeros_like(acc) if unsure is None else scale.abs() * F.conv2d(
            unsure.to(acc.dtype), torch.ones_like(w), None, st, k // 2)
        v = acc * scale + add
        unsure = v.abs() <= SIGN_ROUNDING * ((acc * scale).abs() + add.abs()) + allow
        t = torch.relu(v)
    return allow


def serve_pairs(ref, low, q, requests):
    """The reference following the program over the compared requests
    (``(images, kept modules, logits)`` each; see
    :func:`portbench.traffic.serve_closed.pairs`):

    - ``stem``: the program's ``layer1`` input against the reference's stem
      on the images;
    - ``conv``: where binary layers run as modules, each one's output
      against the reference's binary conv and norm on the program's own
      input to it;
    - ``add``: each such block's output against the reference's residual
      add and ReLU of the program's own branch and shortcut;
    - ``block``: where a block runs as one module (a fused block kernel),
      its output against the reference's block on the program's own input,
      each element's gap less what sign flips inside the block may move it
      (:func:`flip_allowance`): what is left is the block's rounding;
    - ``head``: the served logits against the reference's head on the last
      block's output (a stage that runs whole in one kernel, with the head
      folded in, shows no block's output, and the check reads no number)."""
    import torch

    layers = {l["name"]: l for l in conv_layers(ref.config)}

    def conv(f, name, h):
        norm = name[:-1] + "2" if name.endswith("downsample.1") else name.replace("conv", "bn")
        l = layers[name]
        return f.norm(f.binary_conv(h, name, l["stride"], l["pad"]), norm)

    for x, prog, logits in requests:
        yield "stem", (prog["layer1"][0] if q is None else low.stem(x)), ref.stem(x), None
        for blk in ref.blocks:
            p = blk["prefix"]
            for name in [p + "downsample.1"] + [f"{p}conv{u}" for u in (1, 2, 3)]:
                if name in prog:
                    h, out = prog[name]
                    yield ("conv", out if q is None else conv(low, name, h),
                           conv(ref, name, h), None)
            tail = f"{p}conv{len(blk['units'])}"
            if p[:-1] in prog and tail not in prog:
                h, out = prog[p[:-1]]
                yield ("block", out if q is None else low.block(blk, h),
                       ref.block(blk, h), flip_allowance(ref, blk, h))
            if p[:-1] in prog and tail in prog:
                h, out = prog[p[:-1]]
                short = prog[p + "downsample.1"][1] if blk["downsample"] else h
                branch = prog[tail][1]
                got = out if q is None else low.q(torch.relu(low.q(branch) + low.q(short)))
                yield "add", got, torch.relu(branch + short), None
        features = prog.get(ref.blocks[-1]["prefix"][:-1], (None, None))[1]
        if features is not None:
            yield ("head", logits if q is None else low.head(features),
                   ref.head(features), None)


# --- the training check (portbench.traffic.train_steps) ---

def train_watched(config: dict) -> set:
    """The QAT model's modules whose step-1 input and output the training
    check keeps: the float stem conv, each binary layer and the head."""
    return {"conv1", "fc"} | {l["name"] for l in conv_layers(config)
                              if l["kind"] == "binary"}


def train_layer(f, layer: dict, h):
    """The reference ``f``'s output of one watched ``layer`` (an entry of
    :func:`conv_layers`) on the program's own input ``h``: the float stem
    conv, a binary conv with its output scale, or the head."""
    import torch.nn.functional as F

    name = layer["name"]
    if name == "conv1":
        return F.conv2d(f.q(h), f.q(f.S["conv1.weight"]), None, 2, 3)
    if name == "fc":
        return F.linear(f.q(h), f.q(f.S["fc.weight"]), f.q(f.S["fc.bias"]))
    return f.binary_conv(h, name, layer["stride"], layer["pad"])
