"""Binarizer-state copying between swapped modules (counterpart of
``bnn_tpu/layers/helpers.py``)."""
from __future__ import annotations

import torch
from torch import nn

_BINARIZER_SLOTS = (
    "activation_pre_process",
    "activation_post_process",
    "weight_pre_process",
)


def copy_parameters(source_mod: nn.Module, target_mod: nn.Module, bconfig) -> None:
    """Carry binarizer parameters (e.g. ``BasicScaleBinarizer.alpha``) whose
    names and shapes match from ``source_mod`` into ``target_mod``."""
    for slot in _BINARIZER_SLOTS:
        src = getattr(source_mod, slot, None)
        dst = getattr(target_mod, slot, None)
        if not isinstance(src, nn.Module) or not isinstance(dst, nn.Module):
            continue
        dst_params = dict(dst.named_parameters())
        with torch.no_grad():
            for name, p in src.named_parameters():
                if name in dst_params and dst_params[name].shape == p.shape:
                    dst_params[name].copy_(p)


# the reference's misspelt public name (bnn/layers/helpers.py), kept as an alias
copy_paramters = copy_parameters
