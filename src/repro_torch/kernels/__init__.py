"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``comm_pack`` (the gradient-arena wire path), ``flash_attention``
(forward, dQ and dK/dV), ``rglru`` (the RG-LRU recurrence and its
gradient) and ``rwkv6_wkv`` (the RWKV6 WKV recurrence and its gradient).
Every Pallas kernel of the JAX package has its counterpart here.

Each wrapper counts the calls that launched its kernel in ``.launches``;
``launch_counts()`` reads them all at once.  The JAX package's
``repro.kernels`` names resolve here, its oracles (``*_ref``) among them,
but for two: ``flash_attention`` and ``rglru`` stay the subpackages' names
(their ops of those names are the subpackages' own), and the ``*_pallas``
entry points are the CUDA wrappers."""

from .comm_pack import pack_arena, pack_arena_ref, unpack_arena, unpack_arena_ref
from .flash_attention import (  # the subpackages keep their names: their ops
    attention_ref,                  # ``flash_attention`` and ``rglru`` are not
    flash_attention_bwd,            # re-exported here
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    flash_attention_train,
)
from .rglru import RGLRUScan, rglru_bwd, rglru_fwd, rglru_ref
from .rwkv6_wkv import WKV6Function, wkv, wkv_bwd, wkv_fwd, wkv_ref


def launch_counts() -> dict[str, int]:
    """The launch count of every kernel wrapper, by wrapper name (reading
    them changes nothing)."""
    return {fn.__name__: fn.launches for fn in (
        pack_arena, unpack_arena, flash_attention_fwd, flash_attention_dq,
        flash_attention_dkv, rglru_fwd, rglru_bwd, wkv_fwd, wkv_bwd)}


__all__ = [
    "RGLRUScan",
    "WKV6Function",
    "attention_ref",
    "flash_attention_bwd",
    "flash_attention_dkv",
    "flash_attention_dq",
    "flash_attention_fwd",
    "flash_attention_train",
    "launch_counts",
    "pack_arena",
    "pack_arena_ref",
    "rglru_bwd",
    "rglru_fwd",
    "rglru_ref",
    "unpack_arena",
    "unpack_arena_ref",
    "wkv",
    "wkv_bwd",
    "wkv_fwd",
    "wkv_ref",
]
