"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified].

38L d_model=4096 16H (GQA kv=1 = MQA) head_dim=256 d_ff=12288
vocab=256000.  RG-LRU + local attention in a 2:1 pattern:
12 stages of (rec, rec, attn_local) plus a (rec, rec) tail = 38 layers,
local window 2048, tied embeddings, gemma norms.
"""

import dataclasses

from ..models.common import ArchConfig, Attention, Recurrent


def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        d_ff=12288,
        vocab=256000,
        attention=Attention(n_heads=16, n_kv_heads=1, head_dim=256),
        pattern=("rec", "rec", "attn_local"),
        tail_pattern=("rec", "rec"),
        local_window=2048,
        recurrent=Recurrent(kind="rglru", conv_width=4, lru_width=4096),
        norm="rmsnorm_gemma",
        mlp="geglu",
        tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(),
        name="recurrentgemma-9b-reduced",
        n_layers=8,
        d_model=128,
        d_ff=384,
        vocab=512,
        attention=Attention(n_heads=4, n_kv_heads=1, head_dim=32),
        pattern=("rec", "rec", "attn_local"),
        tail_pattern=("rec", "rec"),
        local_window=64,
        recurrent=Recurrent(kind="rglru", conv_width=4, lru_width=128),
        q_chunk=32,
    )
