from .jax_weights import jax_to_port, load_jax_state
from .precision import cast_float_tree, cast_floats

__all__ = ["cast_float_tree", "cast_floats", "jax_to_port", "load_jax_state"]
