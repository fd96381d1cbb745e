"""MusicGen-large decoder backbone over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (MHA: kv=32) d_ff=8192 vocab=2048.  The EnCodec
frontend is a stub, as in the JAX package: the input is precomputed frame
embeddings (``input_mode='embeds'``); positions are additive sinusoidal, as
in the original (no RoPE).
"""

import dataclasses

from ..models.common import ArchConfig, Attention


def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        d_ff=8192,
        vocab=2048,
        attention=Attention(n_heads=32, n_kv_heads=32, head_dim=64, rope="sinusoidal"),
        pattern=("attn",),
        norm="layernorm",
        mlp="gelu",
        input_mode="embeds",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(),
        name="musicgen-large-reduced",
        n_layers=4,
        d_model=128,
        d_ff=512,
        vocab=64,
        attention=Attention(n_heads=4, n_kv_heads=4, head_dim=32, rope="sinusoidal"),
        q_chunk=32,
    )
