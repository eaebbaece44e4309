"""A toy family for the harness's tests: a plain binary conv net that is not
a ResNet (no blocks, no residual adds), a float stem conv, then
``features`` (binary conv, norm and a learned per-channel PReLU, each layer
strided as the configuration's ``model_args`` say), then the float head.

Names follow the toy model's modules: ``conv1``/``bn1``, ``features.<3i>``
(the binary convs), ``features.<3i+1>`` (their norms), ``features.<3i+2>``
(their PReLUs), ``fc``."""
from __future__ import annotations

from typing import Dict, List

ARCHS = ("tinybnn",)
REFERENCE = "tinybnn"
INITS = {"prelu": ("u", lambda v, shape, fan_in: 0.1 + 0.2 * v)}


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def conv_layers(config: dict) -> List[dict]:
    args = config["model_args"]
    channels, strides = args["channels"], args["strides"]
    out = []

    def add(name, kind, cin, cout, stride, h, stage):
        ho = _out(h, 3, stride, 1)
        out.append({"name": name, "kind": kind, "cin": cin, "cout": cout, "k": 3,
                    "stride": stride, "pad": 1, "h_in": h, "h_out": ho, "stage": stage,
                    "macs": ho * ho * cout * cin * 9})
        return ho

    h = add("conv1", "float", config["in_channels"], channels[0], strides[0],
            config["image_size"], 0)
    for i, (cin, cout, s) in enumerate(zip(channels, channels[1:], strides[1:])):
        h = add(f"features.{3 * i}", "binary", cin, cout, s, h, i + 1)
    out.append({"name": "fc", "kind": "float", "cin": channels[-1],
                "cout": config["num_classes"], "k": 1, "stride": 1, "pad": 0, "h_in": 1,
                "h_out": 1, "stage": len(channels), "macs": channels[-1] * config["num_classes"]})
    return out


def binary_names(config: dict) -> List[str]:
    return [l["name"] for l in conv_layers(config) if l["kind"] == "binary"]


def state_spec(config: dict) -> List[tuple]:
    spec = []

    def norm(prefix, c):
        spec.extend([(prefix + ".weight", (c,), "bn_weight"),
                     (prefix + ".bias", (c,), "bn_bias"),
                     (prefix + ".running_mean", (c,), "bn_mean"),
                     (prefix + ".running_var", (c,), "bn_var"),
                     (prefix + ".num_batches_tracked", (), "count")])

    layers = conv_layers(config)
    stem = layers[0]
    spec.append(("conv1.weight", (stem["cout"], stem["cin"], 3, 3), "conv"))
    norm("bn1", stem["cout"])
    for l in layers[1:-1]:
        i = int(l["name"].split(".")[1])
        spec.append((l["name"] + ".weight", (l["cout"], l["cin"], 3, 3), "conv"))
        spec.append((l["name"] + ".activation_post_process.alpha", (1, l["cout"], 1, 1),
                     "alpha"))
        norm(f"features.{i + 1}", l["cout"])
        spec.append((f"features.{i + 2}.weight", (l["cout"],), "prelu"))
    fc = layers[-1]
    spec.append(("fc.weight", (fc["cout"], fc["cin"]), "linear"))
    spec.append(("fc.bias", (fc["cout"],), "linear"))
    return spec


def fan_in(spec_by_name: Dict[str, tuple], name: str) -> int:
    return spec_by_name[name.rsplit(".", 1)[0] + ".weight"][1]


def published_name(name: str) -> str:
    return name


def watched_names(config: dict) -> set:
    return {"features"} | set(binary_names(config))


def serve_pairs(ref, low, q, requests):
    """``stem``: the first binary conv's input against the reference's stem;
    ``conv``: each binary conv's output (its norm folded in) against the
    reference's on the program's own input; ``head``: the logits against
    the reference's head on the program's ``features``."""
    names = binary_names(ref.config)
    for x, prog, logits in requests:
        yield "stem", (prog[names[0]][0] if q is None else low.stem(x)), ref.stem(x), None
        for name in names:
            h, out = prog[name]
            yield "conv", (out if q is None else low.conv(name, h)), ref.conv(name, h), None
        features = prog["features"][1]
        yield ("head", logits if q is None else low.head(features), ref.head(features),
               None)


def train_watched(config: dict) -> set:
    return {"conv1", "fc"} | set(binary_names(config))


def train_layer(f, layer: dict, h):
    import torch.nn.functional as F

    name = layer["name"]
    if name == "conv1":
        return F.conv2d(f.q(h), f.q(f.S["conv1.weight"]), None, layer["stride"], 1)
    if name == "fc":
        return F.linear(f.q(h), f.q(f.S["fc.weight"]), f.q(f.S["fc.bias"]))
    return f.binary_conv(h, name, layer["stride"], layer["pad"])
