"""Gemma2-2B [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) head_dim=256 d_ff=9216 vocab=256000.
Alternating local(4096)/global attention, GeGLU, gemma RMSNorm (scale+1)
with pre+post block norms, attention-logit softcap 50, final-logit softcap
30, tied embeddings.
"""

import dataclasses

from ..models.common import ArchConfig, Attention


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        d_ff=9216,
        vocab=256000,
        attention=Attention(
            n_heads=8, n_kv_heads=4, head_dim=256, softcap=50.0, rope_theta=10000.0
        ),
        pattern=("attn_local", "attn_global"),
        local_window=4096,
        norm="rmsnorm_gemma",
        post_norm=True,
        mlp="geglu",
        tie_embeddings=True,
        logit_softcap=30.0,
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(),
        name="gemma2-2b-reduced",
        n_layers=4,
        d_model=128,
        d_ff=512,
        vocab=512,
        attention=Attention(n_heads=4, n_kv_heads=2, head_dim=32, softcap=50.0),
        local_window=64,
        q_chunk=32,
    )
