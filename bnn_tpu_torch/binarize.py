"""Model transformation pass: float module tree -> binary one (counterpart of
``bnn_tpu/binarize.py``).

Selects swappable leaves by exact type, resolves ignore rules (literal names,
``$regex$`` patterns and the ``_first_``/``_last_`` special words, taken in
construction order), applies per-layer BConfig overrides, and replaces the
selected leaves with binary layers that adopt the float Parameters.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import re
from typing import Dict, Iterator, List, Optional, Tuple

from torch import nn

from . import layers as blayers
from .bconfig import BConfig

__all__ = [
    "DEFAULT_MODULE_MAPPING",
    "named_modules",
    "get_module_by_name",
    "set_module_by_name",
    "get_modules_to_binarize",
    "swap_modules_by_name",
    "prepare_binary_model",
]

DEFAULT_MODULE_MAPPING: Dict[type, type] = {
    nn.Linear: blayers.Linear,
    nn.Conv2d: blayers.Conv2d,
    nn.Conv1d: blayers.Conv1d,
}
# identity self-mapping so already-binary modules can be re-converted
for _v in list(DEFAULT_MODULE_MAPPING.values()):
    DEFAULT_MODULE_MAPPING[_v] = _v


def named_modules(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """``(dotted_name, module)`` depth-first, root first, each module once:
    ``Module.named_modules``."""
    return model.named_modules()


def get_module_by_name(model: nn.Module, name: str) -> nn.Module:
    """The submodule at the dotted ``name`` (``Module.get_submodule``)."""
    return model.get_submodule(name)


def set_module_by_name(model: nn.Module, name: str, new: nn.Module) -> None:
    parent_name, _, last = name.rpartition(".")
    setattr(model.get_submodule(parent_name), last, new)


def _get_first_layer(model: nn.Module, modules_mapping) -> List[str]:
    for name, module in model.named_modules():
        if type(module) in modules_mapping:
            return [name]
    return []


def _get_last_layer(model: nn.Module, modules_mapping) -> List[str]:
    last = []
    for name, module in model.named_modules():
        if type(module) in modules_mapping:
            last = [name]
    return last


def _regex_match(model: nn.Module, pattern: str, modules_mapping) -> List[str]:
    compiled = re.compile(pattern[1:-1])  # pattern arrives wrapped in $...$
    return [name for name, module in model.named_modules()
            if type(module) in modules_mapping
            and compiled.search(name) is not None]


_KNOWN_SPECIAL_WORDS = {
    "_first_": _get_first_layer,
    "_last_": _get_last_layer,
}


def _resolve_ignore_names(model, ignore_layers_name, modules_mapping) -> List[str]:
    processed: List[str] = []
    for name in ignore_layers_name:
        if name in _KNOWN_SPECIAL_WORDS:
            processed += _KNOWN_SPECIAL_WORDS[name](model, modules_mapping)
        elif len(name) >= 2 and name[0] == "$" and name[-1] == "$":
            processed += _regex_match(model, name, modules_mapping)
        else:
            processed.append(name)
    return processed


def get_modules_to_binarize(
    model: nn.Module,
    bconfig: BConfig,
    modules_mapping: Optional[Dict[type, type]] = None,
    custom_config_layers_name: Dict[str, BConfig] = {},
    ignore_layers_name: List[str] = [],
    update: bool = False,
) -> Dict[str, nn.Module]:
    """Build the ``name -> replacement module`` map."""
    if modules_mapping is None:
        modules_mapping = DEFAULT_MODULE_MAPPING
    ignore = set(_resolve_ignore_names(model, ignore_layers_name,
                                       modules_mapping))
    matched_custom = set()
    modules_to_replace: Dict[str, nn.Module] = {}
    for name, module in model.named_modules():
        if type(module) in modules_mapping:
            if name in ignore:
                continue
            layer_config = copy.copy(bconfig)
            if name in custom_config_layers_name:
                matched_custom.add(name)
                for f in dataclasses.fields(custom_config_layers_name[name]):
                    setattr(layer_config, f.name,
                            getattr(custom_config_layers_name[name], f.name))
            modules_to_replace[name] = modules_mapping[type(module)].from_module(
                module, layer_config, update=update)
        elif name in custom_config_layers_name:
            matched_custom.add(name)
            logging.warning(
                "Module named %s exists but its type %s is not binarizable "
                "(no mapping entry) — the per-layer config is not applied.",
                name, type(module).__name__)
    for name in set(custom_config_layers_name) - matched_custom:
        logging.warning(
            "Module named %s defined in the configuration was not found.", name)
    return modules_to_replace


def swap_modules_by_name(
    model: nn.Module,
    modules_to_replace: Dict[str, nn.Module],
    modules_mapping: Optional[Dict[type, type]] = None,
) -> nn.Module:
    """Replace modules in place by dotted name; if the model itself is the
    module to replace, return the replacement.

    ``modules_mapping`` is taken for the reference's signature
    (bnn/binarize.py:106-107) and not used: the names in
    ``modules_to_replace`` already pin each target, so no type filter is
    needed. A module referenced from two parents (weight tying) appears in
    ``modules_to_replace`` only at its first path, so every other path to
    the same original is rewritten to the same replacement too."""
    if "" in modules_to_replace:
        return modules_to_replace[""]
    id_to_new = {id(model.get_submodule(name)): new
                 for name, new in modules_to_replace.items()}
    swaps = [(path, id_to_new[id(m)])
             for path, m in model.named_modules(remove_duplicate=False)
             if path and id(m) in id_to_new]
    for path, new in swaps:
        set_module_by_name(model, path, new)
    return model


def prepare_binary_model(
    model: nn.Module,
    bconfig: BConfig,
    modules_mapping: Optional[Dict[type, type]] = None,
    custom_config_layers_name: Dict[str, BConfig] = {},
    ignore_layers_name: List[str] = [],
    update: bool = False,
) -> nn.Module:
    """Binarize ``model`` according to ``bconfig``; weight and bias
    Parameters are adopted by reference."""
    modules_to_replace = get_modules_to_binarize(
        model, bconfig, modules_mapping, custom_config_layers_name,
        ignore_layers_name, update=update)
    return swap_modules_by_name(model, modules_to_replace, modules_mapping)
