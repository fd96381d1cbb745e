"""The dense decoder LM and the weight bridge to the JAX package."""

from .common import ArchConfig, Attention
from .transformer import (
    Transformer,
    from_jax_params,
    load_arrays,
    param_shapes,
    to_jax_params,
)

__all__ = [
    "ArchConfig",
    "Attention",
    "Transformer",
    "from_jax_params",
    "load_arrays",
    "param_shapes",
    "to_jax_params",
]
