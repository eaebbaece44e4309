from .checkpoint import (gather_replicated, load_checkpoint,
                         optimizer_state_dict, restore_into,
                         restore_optimizer, save_checkpoint)
from .jax_weights import jax_to_port, load_jax_state
from .precision import cast_float_tree, cast_floats

__all__ = ["cast_float_tree", "cast_floats", "gather_replicated",
           "jax_to_port", "load_checkpoint", "load_jax_state",
           "optimizer_state_dict", "restore_into", "restore_optimizer",
           "save_checkpoint"]
