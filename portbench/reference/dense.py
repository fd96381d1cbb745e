"""A dense pre-norm decoder layer (StarCoder2's block as the configuration
runs it): LayerNorm, grouped-query causal attention with rotary positions,
a tanh-GeLU MLP, no projection biases."""

from __future__ import annotations

import torch

from .common import gelu_tanh, layernorm, rope

LAYER = ("norm1.scale", "norm1.bias", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
         "norm2.scale", "norm2.bias", "mlp.w_up", "mlp.w_down")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mm) -> torch.Tensor:
    """Causal attention of (B, S, H, hd) queries over (B, S, Hkv, hd) keys
    and values; query head h reads key head h // (H / Hkv)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd).permute(0, 2, 3, 1, 4)  # (B, Hkv, G, S, hd)
    kt = k.permute(0, 2, 3, 1)[:, :, None]  # (B, Hkv, 1, hd, S)
    vv = v.permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, S, hd)
    scores = mm(qg, kt) * hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return mm(p, vv).permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)


def layer(P: dict, x: torch.Tensor, cfg: dict, mm) -> torch.Tensor:
    B, S, _ = x.shape
    H, Hkv, hd, eps = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["norm_eps"]
    h = layernorm(x, P["norm1.scale"], P["norm1.bias"], eps)
    q = rope(mm(h, P["attn.wq"]).reshape(B, S, H, hd), cfg["rope_theta"])
    k = rope(mm(h, P["attn.wk"]).reshape(B, S, Hkv, hd), cfg["rope_theta"])
    v = mm(h, P["attn.wv"]).reshape(B, S, Hkv, hd)
    x = mm.operand(x + mm(attention(q, k, v, mm), P["attn.wo"]))
    h = layernorm(x, P["norm2.scale"], P["norm2.bias"], eps)
    return mm.operand(x + mm(gelu_tanh(mm(h, P["mlp.w_up"])), P["mlp.w_down"]))
