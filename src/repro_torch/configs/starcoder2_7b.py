"""StarCoder2-7B [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.  Full (dense)
causal attention, as the JAX package's config has it; the public model
also uses a 4096 sliding window, which that config leaves out.
"""

import dataclasses

from ..models.common import ArchConfig, Attention


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-7b",
        family="dense",
        n_layers=32,
        d_model=4608,
        d_ff=18432,
        vocab=49152,
        attention=Attention(n_heads=36, n_kv_heads=4, head_dim=128, rope_theta=1e5),
        pattern=("attn",),
        norm="layernorm",
        mlp="gelu",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(),
        name="starcoder2-7b-reduced",
        n_layers=4,
        d_model=144,
        d_ff=576,
        vocab=512,
        attention=Attention(n_heads=6, n_kv_heads=2, head_dim=24, rope_theta=1e5),
        q_chunk=32,
    )
