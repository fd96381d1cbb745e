"""Qwen2-VL-2B text backbone [arXiv:2409.12191].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, M-RoPE with
(t, h, w) sections (16, 24, 24) over head_dim 128.  The vision frontend is
a stub, as in the JAX package: the input is precomputed patch embeddings
(``input_mode='embeds'``) with three equal M-RoPE position streams (text).
"""

import dataclasses

from ..models.common import ArchConfig, Attention


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        d_ff=8960,
        vocab=151936,
        attention=Attention(
            n_heads=12,
            n_kv_heads=2,
            head_dim=128,
            rope="mrope",
            mrope_sections=(16, 24, 24),
            rope_theta=1e6,
        ),
        pattern=("attn",),
        norm="rmsnorm",
        mlp="swiglu",
        input_mode="embeds",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(),
        name="qwen2-vl-2b-reduced",
        n_layers=4,
        d_model=96,
        d_ff=256,
        vocab=512,
        attention=Attention(
            n_heads=4,
            n_kv_heads=2,
            head_dim=24,
            rope="mrope",
            mrope_sections=(4, 4, 4),
            rope_theta=1e6,
        ),
        q_chunk=32,
    )
