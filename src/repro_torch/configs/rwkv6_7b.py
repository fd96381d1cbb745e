"""RWKV6 "Finch" 7B [arXiv:2404.05892]: attention-free, a data-dependent
decay linear recurrence (WKV6) and a squared-ReLU channel mix.

32L d_model=4096 d_ff=14336 vocab=65536, WKV head size 64 (64 heads);
layernorm, untied head.
"""

import dataclasses

from ..models.common import ArchConfig, Recurrent


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab=65536,
        attention=None,
        pattern=("rwkv",),
        recurrent=Recurrent(kind="rwkv6", head_dim=64),
        norm="layernorm",
        mlp="rwkv_cmix",  # built into the block
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(),
        name="rwkv6-7b-reduced",
        n_layers=3,
        d_model=128,
        d_ff=448,
        vocab=256,
        recurrent=Recurrent(kind="rwkv6", head_dim=32),
        rec_chunk=16,
    )
