"""StarCoder2-3B [arXiv:2402.19173].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""

import dataclasses

from ..models.common import ArchConfig, Attention


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        d_ff=12288,
        vocab=49152,
        attention=Attention(n_heads=24, n_kv_heads=2, head_dim=128, rope_theta=1e5),
        pattern=("attn",),
        norm="layernorm",
        mlp="gelu",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(),
        name="starcoder2-3b-reduced",
        n_layers=4,
        d_model=96,
        d_ff=384,
        vocab=512,
        attention=Attention(n_heads=4, n_kv_heads=2, head_dim=24, rope_theta=1e5),
        q_chunk=32,
    )
