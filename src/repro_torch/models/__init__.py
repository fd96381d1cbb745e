"""The decoder LM, its serving caches (``init_caches``) and the weight
bridge to the JAX package."""

from .common import ArchConfig, Attention
from .transformer import (
    Transformer,
    from_jax_params,
    init_caches,
    load_arrays,
    param_shapes,
    to_jax_params,
)

__all__ = [
    "ArchConfig",
    "Attention",
    "Transformer",
    "from_jax_params",
    "init_caches",
    "load_arrays",
    "param_shapes",
    "to_jax_params",
]
