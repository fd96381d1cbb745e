"""RG-LRU: the recurrence kernels (CUDA), the differentiable op built on
them, and their plain versions."""

from .ops import RGLRUScan, reset_counts, rglru, rglru_bwd, rglru_fwd
from .ref import rglru_bwd_ref, rglru_ref, rglru_scan_ref

__all__ = [
    "RGLRUScan",
    "reset_counts",
    "rglru",
    "rglru_bwd",
    "rglru_bwd_ref",
    "rglru_fwd",
    "rglru_ref",
    "rglru_scan_ref",
]
