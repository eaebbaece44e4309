from .jax_weights import load_jax_state
from .precision import cast_floats

__all__ = ["cast_floats", "load_jax_state"]
