"""RWKV6 WKV: the recurrence kernels (CUDA), the differentiable op built on
them, and their plain versions."""

from .ops import WKV6Function, reset_counts, wkv, wkv_bwd, wkv_fwd
from .ref import wkv_bwd_ref, wkv_ref

__all__ = [
    "WKV6Function",
    "reset_counts",
    "wkv",
    "wkv_bwd",
    "wkv_bwd_ref",
    "wkv_fwd",
    "wkv_ref",
]
