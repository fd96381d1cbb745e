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
the sequential recurrence of ``wkv_ref`` for any decay.

Serving carries a state per row (``init_rwkv6_state``): ``{'tm': {'shift':
(B, D), 'wkv': (B, H, K, K)}, 'cm': (B, D)}``, the last token's normed
features before each mix, in ``param_dtype``, and the WKV state, f32.  The
time mix hands ``wkv`` to the kernels as ``s0`` and takes ``s_final`` back;
every tensor of the state is overwritten in place, so a one-token decode
step runs the kernels at T = 1.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv6_wkv import wkv
from ..parallel.context import constrain
from ..parallel.sharding import is_dtensor, on_local_shards
from .common import ArchConfig
from .layers import LayerNorm

LORA_MIX = 32  # low-rank size of the 5-way interpolation lora
LORA_DECAY = 64  # low-rank size of the decay lora


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def token_shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """The previous token's features: ``prev`` (B, D) before the first
    token, zeros when None."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


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
        self.hd, self.rec_chunk = hd, cfg.rec_chunk

    def forward(self, x: torch.Tensor, state: dict | None = None):
        """x (B, T, D), already normed by the caller -> (out (B, T, D), new
        state, or None without ``state``); the state ``{'shift', 'wkv'}`` is
        read, then overwritten in place."""
        B, T, D = x.shape
        hd = self.hd
        H = D // hd
        xx = token_shift(x, None if state is None else state["shift"]) - x
        xxx = x + xx * self.mu_x
        a = torch.tanh(xxx @ self.lora_a).float().reshape(B, T, 5, LORA_MIX)
        m = torch.einsum("btkl,kld->btkd", a, self.lora_b.float())  # (B, T, 5, D) f32
        mix = x[:, :, None, :] + xx[:, :, None, :] * (self.mu_rkvwg.to(x.dtype) + m.to(x.dtype))
        x_r, x_k, x_v, x_w, x_g = mix.unbind(2)

        r = constrain((x_r @ self.w_r).reshape(B, T, H, hd), {0: "batch", 2: "model"})
        k = constrain((x_k @ self.w_k).reshape(B, T, H, hd), {0: "batch", 2: "model"})
        v = constrain((x_v @ self.w_v).reshape(B, T, H, hd), {0: "batch", 2: "model"})
        g = constrain(F.silu(x_g @ self.w_g), {0: "batch"})
        ww = torch.tanh(x_w @ self.decay_a).float() @ self.decay_b.float()
        w = torch.exp(-torch.exp(self.decay_base + ww)).reshape(B, T, H, hd)  # (0, 1)

        s0 = None if state is None else state["wkv"]
        if not is_dtensor(r):
            out, s_final = wkv(r, k, v, w, self.u, s0)
        else:  # a DTensor (the dry run): the JAX model's chunked form, on each rank's
            # (batch, head) shard, differentiated by autograd
            seq = (0, 1, 2, 3)
            chunked = functools.partial(wkv_jax_chunked, chunk=self.rec_chunk)
            out, s_final = on_local_shards(chunked, r, (r, k, v, w, self.u, s0),
                                           (seq, seq, seq, seq, (2, 3), (0, 2, None, None)),
                                           (seq, (0, 2, None, None)))
        # per-head group norm: population variance, eps 1e-5, no bias
        mu = torch.mean(out, dim=-1, keepdim=True)
        var = torch.var(out, dim=-1, keepdim=True, correction=0)
        out = ((out - mu) * torch.rsqrt(var + 1e-5)).reshape(B, T, D) * self.gn_scale.float()
        out = (out.to(x.dtype) * g) @ self.w_o
        if state is None:
            return out, None
        state["shift"].copy_(x[:, -1])
        state["wkv"].copy_(s_final)
        return out, state


def wkv_jax_chunked(r, k, v, w, u, s0=None, *, chunk: int = 128):
    """The JAX model's chunked WKV6 (``repro/models/rwkv6.py`` ``wkv_chunked``),
    op for op: per chunk of ``chunk`` steps the decays as cumulative products,
    the inter-chunk product with the state, the masked intra-chunk products
    and the bonus.  It divides by a cumulative decay (C), so the port runs it
    only where no number is computed: the dry run's count, on ``meta``
    shards.  ``out`` (B, T, H, K) and ``s_final`` (B, H, K, K), f32."""
    B, T, H, K = r.shape
    chunk = min(chunk, T)
    T0 = T
    if T % chunk:
        pad = chunk - T % chunk
        r, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
        T += pad
    n = T // chunk

    def chunks(a):  # (B, T, H, K) -> (N, B, H, C, K)
        return a.float().reshape(B, n, chunk, H, K).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(chunks, (r, k, v, w))
    logw = torch.log(torch.clamp(wc, min=1e-30))
    clw = torch.cumsum(logw, dim=-2)
    S = torch.zeros(B, H, K, K, dtype=torch.float32, device=r.device) if s0 is None else s0.float()
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=r.device), diagonal=-1)
    outs = []
    for c in range(n):
        w_prev, w_inc = torch.exp(clw[c] - logw[c]), torch.exp(clw[c])
        w_end = w_inc[..., -1:, :]
        r_t, k_t = rc[c] * w_prev, kc[c] / torch.clamp(w_inc, min=1e-30)
        inter = torch.einsum("bhck,bhkv->bhcv", r_t, S)
        a = torch.einsum("bhck,bhdk->bhcd", r_t, k_t)
        intra = torch.einsum("bhcd,bhdv->bhcv", torch.where(mask, a, 0.0), vc[c])
        diag = torch.einsum("bhck,bhck->bhc", rc[c], u[None, :, None, :] * kc[c])
        outs.append(inter + intra + diag[..., None] * vc[c])
        S = S * w_end.squeeze(-2)[..., :, None] + torch.einsum("bhck,bhcv->bhkv", k_t * w_end, vc[c])
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, T, H, K)
    return out[:, :T0], S


class ChannelMix(nn.Module):
    """``{'mu_k', 'mu_r', 'w_k', 'w_v', 'w_r'}``:
    ``sigmoid(x_r @ w_r) * (relu(x_k @ w_k)² @ w_v)`` over token-shift mixes."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
        mk = lambda *shape: _param(*shape, dtype=pd, device=device)
        self.mu_k, self.mu_r = mk(d), mk(d)
        self.w_k, self.w_v, self.w_r = mk(d, f), mk(f, d), mk(d, d)

    def forward(self, x: torch.Tensor, state: torch.Tensor | None = None):
        """x (B, T, D) -> (out, new state): the state is the previous
        token's features (B, D), overwritten in place; None without one."""
        xx = token_shift(x, state) - x
        x_k = x + xx * self.mu_k
        x_r = x + xx * self.mu_r
        kk = constrain(torch.square(torch.relu(x_k @ self.w_k)), {0: "batch", 2: "model"})
        out = constrain(torch.sigmoid(x_r @ self.w_r) * (kk @ self.w_v), {0: "batch"})
        if state is None:
            return out, None
        state.copy_(x[:, -1])
        return out, state


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

    def forward(self, x: torch.Tensor, positions: torch.Tensor | None = None,
                cache: dict | None = None, q_offset=0):
        """x (B, T, D) -> (x, None, new state): the sublayer protocol of
        ``models.transformer`` (no MoE aux).  ``positions`` and ``q_offset``
        are unused (no RoPE); ``cache`` is the layer's decode state, None
        in training."""
        h, tm = self.tm(self.ln1(x), None if cache is None else cache["tm"])
        x = x + h
        h, cm = self.cm(self.ln2(x), None if cache is None else cache["cm"])
        return x + h, None, (None if cache is None else {"tm": tm, "cm": cm})


def init_rwkv6_state(cfg: ArchConfig, batch: int, device=None) -> dict:
    """A zero decode state for ``batch`` rows, as the JAX package's:
    token-shift rows in ``param_dtype``, the WKV state f32."""
    d, hd = cfg.d_model, cfg.recurrent.head_dim
    pd = cfg.param_dtype
    return {
        "tm": {
            "shift": torch.zeros(batch, d, dtype=pd, device=device),
            "wkv": torch.zeros(batch, d // hd, hd, hd, dtype=torch.float32, device=device),
        },
        "cm": torch.zeros(batch, d, dtype=pd, device=device),
    }
