"""Optimizers over dicts of named tensors."""

from .optimizers import (
    OptState,
    Optimizer,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    make_optimizer,
    sgd_init,
    sgd_update,
)

__all__ = [
    "OptState",
    "Optimizer",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "make_optimizer",
    "sgd_init",
    "sgd_update",
]
