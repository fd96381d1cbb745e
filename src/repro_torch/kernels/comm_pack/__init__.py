"""The gradient-arena pack/unpack kernels (CUDA) and their plain versions."""

from .ops import build, pack_arena, reset_counts, unpack_arena
from .ref import pack_arena_ref, unpack_arena_ref

__all__ = [
    "build",
    "pack_arena",
    "pack_arena_ref",
    "reset_counts",
    "unpack_arena",
    "unpack_arena_ref",
]
