"""Transformer building blocks (counterpart of ``repro/models/layers.py``):
RMSNorm (plain and gemma), LayerNorm, RoPE, GQA attention (causal, optionally over a
sliding window) and the gated MLPs (SwiGLU, GeGLU).

``ArchConfig.attn_impl`` picks the attention (the JAX package's
``attn_impl``, ``'pallas' | 'jnp'``):

- ``'flash'`` (default): ``kernels.flash_attention.flash_attention_train``,
  the forward, dQ and dK/dV kernels on the card (their plain versions on
  the CPU); no (S, S) tensor is kept for backward.
- ``'plain'``: ``gqa_attention``, the path the JAX package runs at model
  level (its q-chunked causal branch): einsum scores, a mask with value
  ``-1e30``, an f32 softmax cast to the input dtype, an einsum with V.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention import flash_attention_train
from .common import ArchConfig, Attention

ATTN_IMPLS = ("flash", "plain")
NORMS = ("rmsnorm", "rmsnorm_gemma", "layernorm")
MLPS = ("swiglu", "geglu")


class RMSNorm(nn.Module):
    """``{'scale': (dim,)}``, computed in f32 and cast back.  ``gemma``
    stores the scale as scale - 1 (initialised to zeros)."""

    def __init__(self, dim: int, dtype: torch.dtype, device=None, gemma: bool = False):
        super().__init__()
        self.gemma = gemma
        self.scale = nn.Parameter(
            torch.full((dim,), 0.0 if gemma else 1.0, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.scale, x, self.gemma)


def apply_norm(scale: torch.Tensor, x: torch.Tensor, gemma: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    s = scale.float()
    if gemma:
        s = s + 1.0  # gemma stores scale - 1
    return (y * s).to(x.dtype)


class LayerNorm(nn.Module):
    """``{'scale': (dim,), 'bias': (dim,)}``: population variance, eps 1e-5,
    computed in f32 and cast back to the input dtype."""

    def __init__(self, dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


def make_norm(cfg: ArchConfig, device=None) -> nn.Module:
    """The norm ``cfg.norm`` names, over ``d_model``."""
    if cfg.norm == "layernorm":
        return LayerNorm(cfg.d_model, cfg.param_dtype, device)
    return RMSNorm(cfg.d_model, cfg.param_dtype, device, cfg.norm == "rmsnorm_gemma")


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32, device=x.device)
    ang = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gqa_attention(
    q: torch.Tensor,  # (B, S, Hq, hd) — rope already applied
    k: torch.Tensor,  # (B, T, Hkv, hd)
    v: torch.Tensor,  # (B, T, Hkv, hd)
    *,
    window: int | None = None,
    q_chunk: int = 256,
) -> torch.Tensor:
    """Query-chunked causal attention, over the last ``window`` keys of each
    query when given (``qpos - kpos < window``); returns (B, S, Hq, hd).

    Each chunk of ``q_chunk`` queries sees every key, so the softmax is
    the full row softmax; the chunking only bounds score memory."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    scale = hd ** -0.5
    kpos = torch.arange(T, device=q.device)

    def one_chunk(start: int, n: int) -> torch.Tensor:
        qs = qg[:, start : start + n]
        scores = torch.einsum("bskgh,btkh->bkgst", qs, k).float() * scale
        qpos = start + torch.arange(n, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        scores = torch.where(mask, scores, torch.tensor(-1e30, dtype=scores.dtype, device=q.device))
        p = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bkgst,btkh->bskgh", p, v)

    if S <= q_chunk:
        return one_chunk(0, S).reshape(B, S, Hq, hd)
    if S % q_chunk:
        raise ValueError(f"sequence {S} is not a multiple of q_chunk {q_chunk}")
    chunks = [one_chunk(s, q_chunk) for s in range(0, S, q_chunk)]
    return torch.cat(chunks, dim=1).reshape(B, S, Hq, hd)


class AttentionBlock(nn.Module):
    """``{'wq', 'wk', 'wv', 'wo'}``: project, RoPE, attend (causal, over the
    last ``window`` keys when given), out-project (training path: no KV
    cache)."""

    def __init__(self, cfg: ArchConfig, att: Attention, device=None, window: int | None = None):
        super().__init__()
        if cfg.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {cfg.attn_impl!r}")
        d = cfg.d_model
        qd, kvd = att.n_heads * att.head_dim, att.n_kv_heads * att.head_dim
        mk = lambda *shape: nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))
        self.wq, self.wk, self.wv, self.wo = mk(d, qd), mk(d, kvd), mk(d, kvd), mk(qd, d)
        self.cfg, self.att, self.window = cfg, att, window

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        att = self.att
        B, S, _ = x.shape
        q = (x @ self.wq).reshape(B, S, att.n_heads, att.head_dim)
        k = (x @ self.wk).reshape(B, S, att.n_kv_heads, att.head_dim)
        v = (x @ self.wv).reshape(B, S, att.n_kv_heads, att.head_dim)
        q = apply_rope(q, positions, att.rope_theta)
        k = apply_rope(k, positions, att.rope_theta)
        if self.cfg.attn_impl == "flash":
            o = flash_attention_train(q, k, v, causal=True, window=self.window)
        else:
            o = gqa_attention(q, k, v, window=self.window, q_chunk=self.cfg.q_chunk)
        return o.reshape(B, S, -1).to(x.dtype) @ self.wo


class MLP(nn.Module):
    """SwiGLU ``silu(x @ w_gate) * (x @ w_up) @ w_down``, or GeGLU with the
    tanh-approximated GeLU in place of SiLU (``cfg.mlp``)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        mk = lambda *shape: nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))
        self.w_gate, self.w_up, self.w_down = mk(d, f), mk(d, f), mk(f, d)
        self.geglu = cfg.mlp == "geglu"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = x @ self.w_gate
        act = F.gelu(z, approximate="tanh") if self.geglu else F.silu(z)
        return (act * (x @ self.w_up)) @ self.w_down
