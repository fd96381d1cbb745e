"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Ported so far: ``comm_pack`` (the gradient-arena wire path),
``flash_attention`` (forward, dQ and dK/dV) and ``rglru`` (the RG-LRU
recurrence and its gradient).  The RWKV6 kernel is still to port."""

from .comm_pack import pack_arena, unpack_arena
from .flash_attention import (  # the subpackages keep their names: their ops
    flash_attention_bwd,            # ``flash_attention`` and ``rglru`` are not
    flash_attention_dkv,            # re-exported here
    flash_attention_dq,
    flash_attention_fwd,
    flash_attention_train,
)
from .rglru import RGLRUScan, rglru_bwd, rglru_fwd

__all__ = [
    "RGLRUScan",
    "flash_attention_bwd",
    "flash_attention_dkv",
    "flash_attention_dq",
    "flash_attention_fwd",
    "flash_attention_train",
    "pack_arena",
    "rglru_bwd",
    "rglru_fwd",
    "unpack_arena",
]
