"""RWKV6 "Finch" block [arXiv:2404.05892] (counterpart of
``repro/models/rwkv6.py``): a token-shift time mix around the WKV6
recurrence with data-dependent decay, then a squared-ReLU channel mix,
each behind a pre-LayerNorm residual.

The recurrence per head (state S of head_dim x head_dim)::

    out_t = r_t · S  +  (r_t · (u ⊙ k_t)) v_t
    S    <- diag(w_t) · S + k_tᵀ v_t

with per-channel, per-step decay ``w_t = exp(-exp(decay_base + lora(x_t)))``.
It runs through ``kernels.rwkv6_wkv.wkv`` (the ``wkv_fwd`` / ``wkv_bwd``
kernels on the card, their plain versions on the CPU).  The JAX model
computes it in chunked form (``wkv_chunked``), whose decay factorisation
breaks where a chunk's decay product falls below 1e-30; the port follows
the sequential recurrence of ``wkv_ref`` for any decay.  Training path
only: no decode state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv6_wkv import wkv
from .common import ArchConfig
from .layers import LayerNorm

LORA_MIX = 32  # low-rank size of the 5-way interpolation lora
LORA_DECAY = 64  # low-rank size of the decay lora


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def token_shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token's features (zeros before the first token)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


class TimeMix(nn.Module):
    """``{'mu_x', 'mu_rkvwg', 'lora_a', 'lora_b', 'w_r', 'w_k', 'w_v', 'w_g',
    'w_o', 'decay_base', 'decay_a', 'decay_b', 'u', 'gn_scale'}``, in
    ``param_dtype`` except ``decay_base`` and ``u``, which are f32 as in the
    JAX package."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, hd, pd = cfg.d_model, cfg.recurrent.head_dim, cfg.param_dtype
        mk = lambda *shape, dtype=pd: _param(*shape, dtype=dtype, device=device)
        self.mu_x, self.mu_rkvwg = mk(d), mk(5, d)
        self.lora_a, self.lora_b = mk(d, 5 * LORA_MIX), mk(5, LORA_MIX, d)
        self.w_r, self.w_k, self.w_v, self.w_g, self.w_o = (mk(d, d) for _ in range(5))
        self.decay_base = mk(d, dtype=torch.float32)
        self.decay_a, self.decay_b = mk(d, LORA_DECAY), mk(LORA_DECAY, d)
        self.u = mk(d // hd, hd, dtype=torch.float32)  # per-head bonus
        self.gn_scale = mk(d)
        self.hd = hd

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, D), already normed by the caller -> (B, T, D)."""
        B, T, D = x.shape
        hd = self.hd
        H = D // hd
        xx = token_shift(x) - x
        xxx = x + xx * self.mu_x
        a = torch.tanh(xxx @ self.lora_a).float().reshape(B, T, 5, LORA_MIX)
        m = torch.einsum("btkl,kld->btkd", a, self.lora_b.float())  # (B, T, 5, D) f32
        mix = x[:, :, None, :] + xx[:, :, None, :] * (self.mu_rkvwg.to(x.dtype) + m.to(x.dtype))
        x_r, x_k, x_v, x_w, x_g = mix.unbind(2)

        r = (x_r @ self.w_r).reshape(B, T, H, hd)
        k = (x_k @ self.w_k).reshape(B, T, H, hd)
        v = (x_v @ self.w_v).reshape(B, T, H, hd)
        g = F.silu(x_g @ self.w_g)
        ww = torch.tanh(x_w @ self.decay_a).float() @ self.decay_b.float()
        w = torch.exp(-torch.exp(self.decay_base + ww)).reshape(B, T, H, hd)  # (0, 1)

        out, _ = wkv(r, k, v, w, self.u)
        # per-head group norm: population variance, eps 1e-5, no bias
        mu = torch.mean(out, dim=-1, keepdim=True)
        var = torch.var(out, dim=-1, keepdim=True, correction=0)
        out = ((out - mu) * torch.rsqrt(var + 1e-5)).reshape(B, T, D) * self.gn_scale.float()
        return (out.to(x.dtype) * g) @ self.w_o


class ChannelMix(nn.Module):
    """``{'mu_k', 'mu_r', 'w_k', 'w_v', 'w_r'}``:
    ``sigmoid(x_r @ w_r) * (relu(x_k @ w_k)² @ w_v)`` over token-shift mixes."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
        mk = lambda *shape: _param(*shape, dtype=pd, device=device)
        self.mu_k, self.mu_r = mk(d), mk(d)
        self.w_k, self.w_v, self.w_r = mk(d, f), mk(f, d), mk(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xx = token_shift(x) - x
        x_k = x + xx * self.mu_k
        x_r = x + xx * self.mu_r
        kk = torch.square(torch.relu(x_k @ self.w_k))
        return torch.sigmoid(x_r @ self.w_r) * (kk @ self.w_v)


class RWKV6Block(nn.Module):
    """One whole RWKV6 layer, ``{'ln1', 'ln2', 'tm', 'cm'}``: time mix and
    channel mix, each behind a pre-LayerNorm residual (no outer norms: the
    ``'rwkv'`` sublayer is this block)."""

    kind = "rwkv"

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.param_dtype, device)
        self.ln2 = LayerNorm(cfg.d_model, cfg.param_dtype, device)
        self.tm = TimeMix(cfg, device)
        self.cm = ChannelMix(cfg, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, T, D) -> (B, T, D); ``positions`` is unused (no RoPE)."""
        x = x + self.tm(self.ln1(x))
        return x + self.cm(self.ln2(x))
