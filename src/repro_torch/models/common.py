"""Shared model configuration (counterpart of ``repro/models/common.py``),
with torch dtypes.

Every option of the JAX package's ten archs is a field: the embeds-input
archs (MusicGen, Qwen2-VL) bring ``input_mode``, ``Attention.rope`` /
``mrope_sections`` and ``qk_norm``.  Of the JAX configs' implementation knobs, ``moe_groups``
(the GShard dispatch groups, set per token shard by the dry run) is kept;
``moe_token_chunk`` (a legacy field nothing reads) and ``chunk_impl`` (how
XLA lowers the attention's query chunks) have no use in the port and are
left out.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Attention:
    """Attention block options (causal; positions per ``rope``)."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int | None = None  # sliding-window size of 'attn' / 'moe' layers (None = full causal)
    softcap: float | None = None  # attention-logit softcap (gemma2)
    rope_theta: float = 10000.0
    # 'rope' | 'mrope' (qwen2-vl: (t, h, w) sections of the rotary half-dims) |
    # 'sinusoidal' (musicgen: added to the embeddings) | 'none' (NoPE)
    rope: str = "rope"
    mrope_sections: tuple[int, int, int] | None = None  # qwen2-vl; they sum to head_dim / 2
    qk_norm: bool = False  # RMS norm of q and k over head_dim before the positions


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
    geglu or the plain GeLU MLP, attention and final-logit softcaps, tied
    or untied embeddings, RoPE, M-RoPE, additive sinusoidal positions or
    none, ``qk_norm``, and token or embeds input; ``models.transformer``
    raises on any other value rather than computing something else."""

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
    input_mode: str = "tokens"  # 'tokens' | 'embeds' (audio / vlm stub frontends: (B, S, d) floats)
    param_dtype: Any = torch.bfloat16
    # local-attention window used by '*_local' pattern entries
    local_window: int = 4096
    # implementation knobs (not architecture):
    q_chunk: int = 256  # query chunk of the plain attention path
    moe_groups: int = 1  # GShard dispatch groups (the token shards under the dry run's rules)
    rec_chunk: int = 128  # the JAX package's time chunk for chunked recurrences
    attn_impl: str = "flash"  # 'flash' (the flash-attention kernels) | 'plain'
    remat: str = "full"  # 'full' (torch.utils.checkpoint per layer) | 'dots' (its 2D products
    # kept, the JAX dots_with_no_batch_dims_saveable) | 'none'

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
