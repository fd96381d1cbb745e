"""Mixtral-8x7B [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000; MoE with 8
experts, top-2 routing; 4096 sliding-window attention.
"""

import dataclasses

from ..models.common import ArchConfig, Attention, MoE


def config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab=32000,
        attention=Attention(
            n_heads=32, n_kv_heads=8, head_dim=128, window=4096, rope_theta=1e6
        ),
        pattern=("moe",),
        moe=MoE(n_experts=8, top_k=2),
        norm="rmsnorm",
        mlp="swiglu",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(),
        name="mixtral-8x7b-reduced",
        n_layers=4,
        d_model=128,
        d_ff=256,
        vocab=256,
        attention=Attention(n_heads=4, n_kv_heads=2, head_dim=32, window=64),
        moe=MoE(n_experts=4, top_k=2),
        q_chunk=32,
    )
