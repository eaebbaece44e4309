"""bnn_tpu_torch — the PyTorch / CUDA port of ``bnn_tpu``.

Module names mirror ``bnn_tpu`` so each counterpart is easy to find; the
layouts are torch's own (NCHW activations, OIHW conv weights, ``(O, I)``
linear weights), so a port ``state_dict`` is a reference-format checkpoint.
The kernel functions in :mod:`bnn_tpu_torch.kernels` keep the JAX kernels'
argument layouts. Hand-written CUDA kernels build at first use, never at
import.
"""

__version__ = "0.1.0"

from .bconfig import BConfig
from .binarize import (
    DEFAULT_MODULE_MAPPING,
    get_modules_to_binarize,
    prepare_binary_model,
    swap_modules_by_name,
)
from .engine import BinaryChef, RecipeError
from . import (data, functional, inference, kernels, layers, models, nn, ops,
               parallel, utils)

__all__ = [
    "BConfig",
    "DEFAULT_MODULE_MAPPING",
    "get_modules_to_binarize",
    "swap_modules_by_name",
    "prepare_binary_model",
    "BinaryChef",
    "RecipeError",
    "data",
    "functional",
    "inference",
    "kernels",
    "layers",
    "models",
    "nn",
    "ops",
    "parallel",
    "utils",
]
