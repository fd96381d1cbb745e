"""TinyLlama-1.1B (llama2 architecture) [arXiv:2401.02385].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""

import dataclasses

from ..models.common import ArchConfig, Attention


def config() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b",
        family="dense",
        n_layers=22,
        d_model=2048,
        d_ff=5632,
        vocab=32000,
        attention=Attention(n_heads=32, n_kv_heads=4, head_dim=64),
        pattern=("attn",),
        norm="rmsnorm",
        mlp="swiglu",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(),
        name="tinyllama-1.1b-reduced",
        n_layers=4,
        d_model=128,
        d_ff=352,
        vocab=256,
        attention=Attention(n_heads=4, n_kv_heads=2, head_dim=32),
        q_chunk=32,
    )
