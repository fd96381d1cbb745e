"""The decoder LM, its serving caches (``init_caches``) and the weight
bridge to the JAX package.  The JAX package's ``forward``, ``init_params``,
``loss_fn`` and ``staged_loss_fns`` are ``Transformer``'s constructor and
methods here (the hook-based step needs no staged loss functions)."""

from .common import ArchConfig, Attention, MoE, Recurrent, param_count
from .transformer import (
    Transformer,
    describe_params,
    from_jax_params,
    init_caches,
    load_arrays,
    param_shapes,
    to_jax_params,
)

__all__ = [
    "ArchConfig",
    "Attention",
    "MoE",
    "Recurrent",
    "Transformer",
    "describe_params",
    "from_jax_params",
    "init_caches",
    "load_arrays",
    "param_count",
    "param_shapes",
    "to_jax_params",
]
