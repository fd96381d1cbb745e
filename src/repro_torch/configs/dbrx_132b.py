"""DBRX-132B [hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352; fine-grained MoE
with 16 experts, top-4 routing.
"""

import dataclasses

from ..models.common import ArchConfig, Attention, MoE


def config() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        d_ff=10752,
        vocab=100352,
        attention=Attention(n_heads=48, n_kv_heads=8, head_dim=128, rope_theta=5e5),
        pattern=("moe",),
        moe=MoE(n_experts=16, top_k=4),
        norm="layernorm",
        mlp="swiglu",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(),
        name="dbrx-132b-reduced",
        n_layers=4,
        d_model=128,
        d_ff=192,
        vocab=512,
        attention=Attention(n_heads=4, n_kv_heads=2, head_dim=32),
        moe=MoE(n_experts=4, top_k=2),
        q_chunk=32,
    )
