"""Flash attention: the forward, dQ and dK/dV kernels (CUDA), the
differentiable op built on them, and their plain versions."""

from .ops import (
    FlashAttentionTrain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    flash_attention_train,
    reset_counts,
)
from .ref import (
    attention_delta,
    attention_ref,
    flash_attention_bwd_ref,
    flash_attention_dkv_ref,
    flash_attention_dq_ref,
    flash_attention_fwd_ref,
)

__all__ = [
    "FlashAttentionTrain",
    "attention_delta",
    "attention_ref",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_ref",
    "flash_attention_dkv",
    "flash_attention_dkv_ref",
    "flash_attention_dq",
    "flash_attention_dq_ref",
    "flash_attention_fwd",
    "flash_attention_fwd_ref",
    "flash_attention_train",
    "reset_counts",
]
