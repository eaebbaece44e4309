"""The system under test, built through the port's public API: the only
module of the benchmark that imports ``bnn_tpu_torch``."""
from __future__ import annotations

from typing import Dict

import torch


def qat_model(config: dict, state: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The configuration's network as the ``bt.models`` constructor its
    ``arch`` names (with the configuration's optional ``model_args``) and
    ``prepare_binary_model`` build it, made without drawing its own weights
    (on the meta device) and then loaded with ``state``."""
    import bnn_tpu_torch as bt
    from bnn_tpu_torch import ops

    recipe = config["recipe"]
    with torch.device("meta"):
        model = getattr(bt.models, config["arch"])(num_classes=config["num_classes"],
                                                   **config.get("model_args", {}))
        model = bt.prepare_binary_model(
            model,
            bt.BConfig(activation_pre_process=getattr(ops, recipe["activation_pre_process"]),
                       activation_post_process=getattr(ops, recipe["activation_post_process"]),
                       weight_pre_process=getattr(ops, recipe["weight_pre_process"])),
            ignore_layers_name=recipe["ignore_layers_name"])
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model


def predictor(model: torch.nn.Module, config: dict, batch_size: int, device, **options):
    """``Predictor`` with its defaults but the batch, the device, the
    configuration's serving dtype and the traffic mix's ``options``."""
    from bnn_tpu_torch.inference import Predictor

    return Predictor(model.eval(), batch_size=batch_size,
                     dtype=getattr(torch, config["dtype"]), device=device, **options)


def train_step(config: dict):
    """``make_train_step`` at the configuration's compute dtype."""
    from bnn_tpu_torch.parallel import make_train_step

    return make_train_step(compute_dtype=getattr(torch, config["train_compute_dtype"]))
