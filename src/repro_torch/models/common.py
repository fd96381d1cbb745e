"""Shared model configuration (counterpart of ``repro/models/common.py``),
with torch dtypes.

Only the options the port implements are fields: those of the eight
token-input archs.  The JAX package's options for the embeds-input archs
(``input_mode``, ``Attention.rope`` / ``mrope_sections`` / ``qk_norm``)
come back with MusicGen and Qwen2-VL.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Attention:
    """Attention block options (causal, RoPE)."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int | None = None  # sliding-window size of 'attn' / 'moe' layers (None = full causal)
    softcap: float | None = None  # attention-logit softcap (gemma2)
    rope_theta: float = 10000.0


@dataclasses.dataclass(frozen=True)
class MoE:
    """Mixture-of-experts options (None on the config = dense FFN)."""

    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class Recurrent:
    """RG-LRU / RWKV-style recurrent block options (``'rec'`` sublayers run
    ``kind='rglru'``, ``'rwkv'`` sublayers ``kind='rwkv6'``)."""

    kind: str  # 'rglru' | 'rwkv6'
    conv_width: int = 4  # temporal conv in the Griffin recurrent block
    lru_width: int | None = None  # defaults to d_model
    head_dim: int = 64  # rwkv6 wkv head size


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (or a reduced smoke variant).

    The port runs patterns of ``'attn'`` (causal attention, over
    ``attention.window`` keys when set), ``'attn_global'`` (over every
    key), ``'attn_local'`` (over ``local_window`` keys), ``'moe'``
    (attention as ``'attn'``, then the MoE FFN of ``models.moe`` in place
    of the MLP), ``'rec'`` (the RG-LRU block) and ``'rwkv'`` (the whole
    RWKV6 layer, its channel mix included: ``mlp='rwkv_cmix'``,
    ``attention=None``) sublayers, with a
    tail, rmsnorm, gemma rmsnorm or layernorm, post-block norms, swiglu,
    geglu or the plain GeLU MLP, attention and final-logit softcaps, and
    tied or untied embeddings; ``models.transformer`` raises on any other
    value rather than computing something else."""

    name: str
    family: str  # audio|dense|moe|ssm|hybrid|vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attention: Attention | None
    # repeating block pattern of one stage; n_layers = len(pattern) *
    # n_stages + len(tail_pattern)
    pattern: tuple[str, ...] = ("attn",)
    tail_pattern: tuple[str, ...] = ()
    moe: MoE | None = None
    recurrent: Recurrent | None = None
    norm: str = "rmsnorm"  # 'rmsnorm' | 'rmsnorm_gemma' (scale stored as scale - 1) | 'layernorm'
    post_norm: bool = False  # gemma2 adds post-block norms
    mlp: str = "swiglu"  # 'swiglu' | 'geglu' | 'gelu' | 'rwkv_cmix' (inside the 'rwkv' block)
    tie_embeddings: bool = False
    logit_softcap: float | None = None
    param_dtype: Any = torch.bfloat16
    # local-attention window used by '*_local' pattern entries
    local_window: int = 4096
    # implementation knobs (not architecture):
    q_chunk: int = 256  # query chunk of the plain attention path
    rec_chunk: int = 128  # the JAX package's time chunk for chunked recurrences
    attn_impl: str = "flash"  # 'flash' (the flash-attention kernels) | 'plain'
    remat: str = "full"  # 'full' (torch.utils.checkpoint per layer) | 'none'

    @property
    def n_stages(self) -> int:
        body = self.n_layers - len(self.tail_pattern)
        if body % len(self.pattern):
            raise ValueError(
                f"{self.name}: {self.n_layers} layers do not tile by pattern "
                f"{self.pattern} + tail {self.tail_pattern}"
            )
        return body // len(self.pattern)

    def block_kinds(self) -> list[str]:
        """Per-layer kinds, length n_layers."""
        return list(self.pattern) * self.n_stages + list(self.tail_pattern)
