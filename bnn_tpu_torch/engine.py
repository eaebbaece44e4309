"""Recipe engine: YAML-driven progressive binarization (counterpart of
``bnn_tpu/engine.py``).

A recipe is a mapping of steps; each step names the three binarizers, the
layers to leave float and, optionally, its optimizer, lr schedule and epoch
budget::

    step0:
      pre_activation:  {name: BasicInputBinarizer}
      post_activation: {name: BasicScaleBinarizer}
      weight:          {name: XNORWeightBinarizer, args: {compute_alpha: true}}
      ignore_layer_names: ["_first_", "_last_", "layer2.0.downsample.1"]

Binarizer names resolve through :mod:`bnn_tpu_torch.ops.registry`; keys are
case-normalised and every section is validated when the chef is built.

Recipe files are read with PyYAML's ``safe_load`` when PyYAML can be
imported, else with :func:`read_block_yaml`, the port's own reader of the
block-style subset the recipes use (``BinaryChef.loader`` says which ran).
``import bnn_tpu_torch`` never imports ``yaml``.
"""
from __future__ import annotations

import inspect
import math
import re
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch import nn

from .bconfig import BConfig
from .binarize import prepare_binary_model
from .ops import registry

__all__ = ["BinaryChef", "RecipeError", "read_block_yaml", "lr_schedule"]

_SLOT_KEYS = ("pre_activation", "post_activation", "weight")
_KNOWN_STEP_KEYS = set(_SLOT_KEYS) | {
    "ignore_layer_names", "optimizer", "lr_schedule", "epochs",
}
_OPTIMIZERS = ("sgd", "adam", "adamw")
_SCHEDULES = ("constant", "cosine", "multistep")


class RecipeError(ValueError):
    """A recipe file failed validation."""


# -- the block-style YAML subset ----------------------------------------------

# PyYAML's (YAML 1.1) implicit scalar types, the ones the recipes use
_BOOL = {"yes": True, "no": False, "true": True, "false": False,
         "on": True, "off": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|^[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$")
# YAML 1.1 numbers outside the subset: octal, hex, binary, base 60, inf, nan
_OTHER_NUMBER = re.compile(
    r"^[-+]?(?:0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|\.(?:inf|Inf|INF)"
    r"|[1-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$|^\.(?:nan|NaN|NAN)$")


def _scalar(text: str, lineno: int) -> Any:
    if text[:1] in "\"'":
        quote = text[0]
        if len(text) < 2 or text[-1] != quote:
            raise RecipeError(f"line {lineno}: unterminated quoted string {text!r}")
        body = text[1:-1]
        if quote == "'":
            return body.replace("''", "'")
        if "\\" in body:
            raise RecipeError(f"line {lineno}: escapes in double-quoted "
                              "strings are not supported without PyYAML")
        return body
    if text[:1] in "{[&*!|>%@`":
        raise RecipeError(f"line {lineno}: {text!r} is outside the block-style "
                          "subset read without PyYAML (no flow collections, "
                          "anchors, tags or block scalars)")
    if _OTHER_NUMBER.match(text):
        raise RecipeError(f"line {lineno}: the number {text!r} is outside the "
                          "subset read without PyYAML")
    if text in _NULL:
        return None
    if text.lower() in _BOOL and text in (text.lower(), text.capitalize(), text.upper()):
        return _BOOL[text.lower()]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    return text


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (outside quotes) and trailing space."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def read_block_yaml(text: str) -> Any:
    """Parse the block-style YAML subset of the repo's recipes: nested
    mappings, ``- `` lists of scalars, ints, floats (``1.0e-3``), bools,
    null, quoted and bare strings and ``#`` comments, with PyYAML's
    (YAML 1.1) scalar rules. Anything else raises :class:`RecipeError`
    naming the line."""
    lines: List[Tuple[int, int, str]] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise RecipeError(f"line {lineno}: tab indentation")
        body = _strip_comment(raw)
        if body.strip() in ("---", "..."):
            raise RecipeError(f"line {lineno}: document markers are not supported")
        if body.strip():
            lines.append((lineno, len(body) - len(body.lstrip()), body.strip()))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][1])
    if end != len(lines):
        raise RecipeError(f"line {lines[end][0]}: unexpected indentation")
    return value


def _block(lines, i: int, indent: int):
    """The mapping or list starting at ``lines[i]`` (indented by
    ``indent``) and the index after it."""
    if lines[i][2].startswith("- ") or lines[i][2] == "-":
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines, i, indent):
    out = []
    while i < len(lines) and lines[i][1] == indent:
        lineno, _, text = lines[i]
        if not (text.startswith("- ") or text == "-"):
            break
        item = text[1:].strip()
        if item.startswith("- ") or re.match(r"^[^\"'].*?:(\s|$)", item):
            raise RecipeError(f"line {lineno}: only lists of scalars are "
                              "supported without PyYAML")
        out.append(_scalar(item, lineno))
        i += 1
    return out, i


def _mapping(lines, i, indent):
    out = {}
    while i < len(lines) and lines[i][1] == indent:
        lineno, _, text = lines[i]
        if text.startswith("- ") or text == "-":
            break
        m = re.match(r"^([^\s\"'#:][^:]*?|\"[^\"]*\"|'[^']*'):(?:\s+(.*))?$", text)
        if m is None:
            raise RecipeError(f"line {lineno}: expected 'key: value', got {text!r}")
        key = _scalar(m.group(1).strip(), lineno)
        if key in out:
            raise RecipeError(f"line {lineno}: duplicate key {key!r}")
        rest = (m.group(2) or "").strip()
        i += 1
        if rest:
            out[key] = _scalar(rest, lineno)
        elif i < len(lines) and (lines[i][1] > indent or (
                lines[i][1] == indent and lines[i][2].startswith("-"))):
            out[key], i = _block(lines, i, lines[i][1])
        else:
            out[key] = None
    if i < len(lines) and lines[i][1] > indent:
        raise RecipeError(f"line {lines[i][0]}: unexpected indentation")
    return out, i


def _load_recipe(path) -> Tuple[Any, str]:
    """``(parsed recipe, name of the loader that read it)``."""
    with open(path) as fh:
        text = fh.read()
    try:
        import yaml
    except ImportError:
        return read_block_yaml(text), "bnn_tpu_torch.engine.read_block_yaml"
    return yaml.safe_load(text), "PyYAML safe_load"


# -- validation -----------------------------------------------------------------

def _normalize_keys(d: Dict[str, Any]) -> Dict[str, Any]:
    return {str(k).lower(): v for k, v in d.items()}


def _build_binarizer_factory(slot: str, spec: Any, step_name: str) -> Callable:
    if not isinstance(spec, dict):
        raise RecipeError(
            f"{step_name}.{slot}: expected a mapping with a 'name' key, got {spec!r}")
    spec = _normalize_keys(spec)
    if "name" not in spec:
        raise RecipeError(f"{step_name}.{slot}: missing required key 'name' "
                          f"(found keys: {sorted(spec)})")
    cls = registry.resolve(str(spec["name"]))
    args = spec.get("args", None)
    if args:
        if not isinstance(args, dict):
            raise RecipeError(f"{step_name}.{slot}.args: expected a mapping, "
                              f"got {args!r}")
        # check the arguments against the constructor now, not as a raw
        # TypeError at the first binarized layer
        try:
            inspect.signature(cls.__init__).bind_partial(None, **args)
        except TypeError as e:
            raise RecipeError(f"{step_name}.{slot}.args: {e} "
                              f"(binarizer {cls.__name__})") from None
        return cls.with_args(**args)
    return cls


def _normalize_ignore_names(value: Any, step_name: str) -> List[str]:
    """A scalar (``ignore_layer_names: _last_``) is one name, not a list of
    its characters."""
    if isinstance(value, str):
        return [value]
    if isinstance(value, (list, tuple)) and all(isinstance(s, str) for s in value):
        return list(value)
    raise RecipeError(f"{step_name}.ignore_layer_names: expected a name or "
                      f"list of names, got {value!r}")


def _validate_section(spec: Any, step_name: str, section: str, names,
                      known) -> Dict[str, Any]:
    if not isinstance(spec, dict):
        raise RecipeError(f"{step_name}.{section}: expected a mapping with a "
                          f"'name' key, got {spec!r}")
    spec = _normalize_keys(spec)
    name = str(spec.get("name", "")).lower()
    if name not in names:
        raise RecipeError(f"{step_name}.{section}.name: {spec.get('name')!r} "
                          f"is not one of {list(names)}")
    unknown = set(spec) - known
    if unknown:
        raise RecipeError(f"{step_name}.{section}: unknown keys "
                          f"{sorted(unknown)}; allowed keys are {sorted(known)}")
    spec["name"] = name
    return spec


def _validate_optimizer_spec(spec: Any, step_name: str) -> Dict[str, Any]:
    return _validate_section(spec, step_name, "optimizer", _OPTIMIZERS,
                             {"name", "lr", "weight_decay", "momentum",
                              "nesterov", "b1", "b2", "eps"})


def _validate_schedule_spec(spec: Any, step_name: str) -> Dict[str, Any]:
    spec = _validate_section(spec, step_name, "lr_schedule", _SCHEDULES,
                             {"name", "milestones", "gamma", "warmup_epochs",
                              "final_factor"})
    if spec["name"] == "multistep" and not isinstance(spec.get("milestones"), list):
        raise RecipeError(f"{step_name}.lr_schedule: 'multistep' requires a "
                          "'milestones' list (epoch indices)")
    return spec


# -- schedules and optimizers ---------------------------------------------------

def lr_schedule(base_lr: float, sched: Dict[str, Any], epochs: int,
                steps_per_epoch: int) -> Callable[[int], float]:
    """The lr at each optimizer step (from 0), as a Python float; the maths
    of the JAX package's optax schedule: a linear warmup from 0 over
    ``warmup_epochs``, then constant, ``cosine_decay_schedule(base, total,
    alpha=final_factor)`` or piecewise-constant decay by ``gamma`` at
    ``milestones``. The milestones are absolute epochs, shifted left by the
    warmup; one on the warmup's boundary is kept."""
    name = sched.get("name", "constant")
    warmup = int(sched.get("warmup_epochs", 0)) * int(steps_per_epoch)
    total = max(1, int(epochs) * int(steps_per_epoch) - warmup)
    if name == "cosine":
        final = float(sched.get("final_factor", 0.0))

        def main(t):
            t = min(t, total)
            decay = 0.5 * (1 + math.cos(math.pi * t / total))
            return base_lr * ((1 - final) * decay + final)
    elif name == "multistep":
        gamma = float(sched.get("gamma", 0.1))
        bounds = sorted({int(m) * steps_per_epoch - warmup: gamma
                         for m in sched.get("milestones", [])
                         if int(m) * steps_per_epoch >= warmup}.items())

        def main(t):
            v = base_lr
            for boundary, scale in bounds:
                if t >= boundary:
                    v = v * scale
            return v
    else:
        def main(t):
            return base_lr

    if warmup <= 0:
        return lambda t: float(main(int(t)))

    def schedule(t):
        t = int(t)
        if t >= warmup:
            return float(main(t - warmup))
        return float((0.0 - base_lr) * (1 - t / warmup) + base_lr)

    return schedule


class _Scheduled:
    """A ``torch.optim`` optimizer whose lr follows ``schedule`` over its own
    steps. The schedule's position is the optimizer's ``step`` state (Adam's
    own per-parameter count; SGD's written beside its momentum), so that
    ``state_dict`` / ``load_state_dict`` (and so ``optimizer_state_dict`` /
    ``restore_optimizer``) carry it, as optax's count is carried. The
    schedule itself, base lr included, is the live optimizer's: a restore
    under another base lr keeps the position."""

    _writes_step = False

    def __init__(self, params, schedule: Callable[[int], float], **kwargs):
        super().__init__(params, lr=schedule(0), **kwargs)
        self.schedule = schedule
        self._count = 0

    def current_lr(self) -> float:
        """The lr the next ``step()`` applies."""
        return self.schedule(self._count)

    def step(self, closure=None):
        lr = self.current_lr()
        for group in self.param_groups:
            group["lr"] = lr
        loss = super().step(closure)
        self._count += 1
        if self._writes_step:
            for group in self.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        self.state[p]["step"] = torch.tensor(float(self._count))
        return loss

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        self._count = max((int(s["step"]) for s in self.state.values()
                           if "step" in s), default=0)


class ScheduledSGD(_Scheduled, torch.optim.SGD):
    _writes_step = True


class ScheduledAdam(_Scheduled, torch.optim.Adam):
    pass


class ScheduledAdamW(_Scheduled, torch.optim.AdamW):
    pass


class BinaryChef:
    """Converts a model step by step according to a YAML recipe::

        chef = BinaryChef("recipe.yaml")
        for i in range(len(chef)):
            model = chef.next(model)
            optimizer = chef.make_optimizer(model, i, steps_per_epoch)
            # ... train this stage ...

    ``config`` is a path to a YAML recipe or an already-parsed dict;
    ``user_modules`` are custom binarizer classes, registered by class name.
    """

    def __init__(self, config, user_modules: List[Callable] = ()):
        for user_module in user_modules:
            registry.register(user_module)
        if isinstance(config, (str, bytes)):
            raw, self.loader = _load_recipe(config)
        else:
            raw, self.loader = config, None
        if not isinstance(raw, dict) or not raw:
            raise RecipeError(
                f"Recipe must be a non-empty mapping of steps, got {type(raw)}")
        self.config = [dict(raw[k]) for k in raw.keys()]
        self._validate()
        self.current_step = 0

    def _validate(self) -> None:
        for i, step in enumerate(self.config):
            step_norm = _normalize_keys(step)
            unknown = set(step_norm) - _KNOWN_STEP_KEYS
            if unknown:
                raise RecipeError(f"step {i}: unknown keys {sorted(unknown)}; "
                                  f"allowed keys are {sorted(_KNOWN_STEP_KEYS)}")
            for slot in _SLOT_KEYS:
                if slot not in step_norm:
                    raise RecipeError(f"step {i}: missing required section '{slot}'")
                _build_binarizer_factory(slot, step_norm[slot], f"step {i}")
            if "optimizer" in step_norm:
                _validate_optimizer_spec(step_norm["optimizer"], f"step {i}")
            if "lr_schedule" in step_norm:
                _validate_schedule_spec(step_norm["lr_schedule"], f"step {i}")
            if "epochs" in step_norm:
                try:
                    ep = int(step_norm["epochs"])
                except (TypeError, ValueError):
                    raise RecipeError(f"step {i}: epochs must be an integer, got "
                                      f"{step_norm['epochs']!r}") from None
                if ep <= 0:
                    raise RecipeError(f"step {i}: epochs must be positive")
            if "ignore_layer_names" in step_norm:
                _normalize_ignore_names(step_norm["ignore_layer_names"], f"step {i}")

    def __len__(self) -> int:
        return len(self.config)

    def get_num_steps(self) -> int:
        return len(self)

    def run_step(self, model: nn.Module, step: int, update: bool = False) -> nn.Module:
        """Apply recipe step ``step`` to ``model``; ``update=True`` carries
        the learnable binarizer state (an output scale's alpha) of layers
        that are binary already."""
        if not 0 <= step < len(self):
            raise IndexError(f"step {step} out of range (recipe has {len(self)})")
        cfg = _normalize_keys(self.config[step])
        name = f"step {step}"
        ignore = _normalize_ignore_names(cfg.get("ignore_layer_names", []) or [], name)
        bconfig = BConfig(
            activation_pre_process=_build_binarizer_factory(
                "pre_activation", cfg["pre_activation"], name),
            activation_post_process=_build_binarizer_factory(
                "post_activation", cfg["post_activation"], name),
            weight_pre_process=_build_binarizer_factory("weight", cfg["weight"], name),
        )
        return prepare_binary_model(model, bconfig=bconfig,
                                    ignore_layers_name=ignore, update=update)

    def next(self, model: nn.Module, update: bool = False) -> nn.Module:
        """Apply the current step; the counter advances only on success."""
        out = self.run_step(model, self.current_step, update=update)
        self.current_step += 1
        return out

    def epochs(self, step: int) -> int:
        """Declared epoch budget of ``step`` (0 if the recipe does not say)."""
        return int(_normalize_keys(self.config[step]).get("epochs", 0))

    def lr_schedule(self, step: int, steps_per_epoch: int = 1) -> Callable[[int], float]:
        """``step``'s lr at each optimizer step, as :func:`lr_schedule`."""
        spec = self._optimizer_spec(step)
        cfg = _normalize_keys(self.config[step])
        sched = (_validate_schedule_spec(cfg["lr_schedule"], f"step {step}")
                 if "lr_schedule" in cfg else {"name": "constant"})
        return lr_schedule(float(spec.get("lr", 1e-3)), sched,
                           self.epochs(step) or 1, steps_per_epoch)

    def _optimizer_spec(self, step: int) -> Dict[str, Any]:
        cfg = _normalize_keys(self.config[step])
        if "optimizer" not in cfg:
            raise RecipeError(f"step {step} has no 'optimizer' section; add one "
                              "to the recipe or build the optimizer yourself")
        return _validate_optimizer_spec(cfg["optimizer"], f"step {step}")

    def make_tx(self, step: int, steps_per_epoch: int = 1) -> Callable:
        """The counterpart of the JAX package's optax transform: a function
        ``params -> torch.optim.Optimizer`` (``ScheduledSGD``,
        ``ScheduledAdam`` or ``ScheduledAdamW``) with ``step``'s optimizer
        and its lr schedule over optimizer steps (epoch milestones x
        ``steps_per_epoch``). ``sgd`` and ``adam`` take ``weight_decay``
        coupled (added to the gradient), ``adamw`` decoupled (scaled by the
        lr); the recipe states the decay per step."""
        spec = self._optimizer_spec(step)
        schedule = self.lr_schedule(step, steps_per_epoch)
        wd = float(spec.get("weight_decay", 0.0))
        name = spec["name"]
        if name == "sgd":
            kw = dict(momentum=float(spec.get("momentum", 0.0)),
                      nesterov=bool(spec.get("nesterov", False)), weight_decay=wd)
            cls = ScheduledSGD
        else:
            kw = dict(betas=(float(spec.get("b1", 0.9)), float(spec.get("b2", 0.999))),
                      eps=float(spec.get("eps", 1e-8)), weight_decay=wd)
            cls = ScheduledAdamW if name == "adamw" else ScheduledAdam
        return lambda params: cls(params, schedule, **kw)

    def make_optimizer(self, model: nn.Module, step: int,
                       steps_per_epoch: int = 1) -> torch.optim.Optimizer:
        """``step``'s optimizer over every parameter of ``model``."""
        return self.make_tx(step, steps_per_epoch)(model.parameters())
