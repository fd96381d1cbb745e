"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Ported so far: ``comm_pack`` (the gradient-arena wire path) and
``flash_attention`` (forward, dQ and dK/dV).  The RG-LRU and RWKV6
kernels are still to port."""

from .comm_pack import pack_arena, unpack_arena
from .flash_attention import (  # the subpackage keeps its name: its op
    flash_attention_bwd,            # ``flash_attention`` is not re-exported here
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    flash_attention_train,
)

__all__ = [
    "flash_attention_bwd",
    "flash_attention_dkv",
    "flash_attention_dq",
    "flash_attention_fwd",
    "flash_attention_train",
    "pack_arena",
    "unpack_arena",
]
