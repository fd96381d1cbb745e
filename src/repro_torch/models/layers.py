"""Transformer building blocks (counterpart of ``repro/models/layers.py``):
RMSNorm (plain and gemma), LayerNorm, RoPE, M-RoPE, sinusoidal positions, GQA
attention (causal, optionally over a sliding window and under a logit softcap,
with an optional RMS norm of q and k), the gated MLPs (SwiGLU, GeGLU), the
plain GeLU MLP and the logit softcap.

``Attention.rope`` picks the positions: ``'rope'`` rotates q and k,
``'mrope'`` (Qwen2-VL) rotates each rotary half-dim by one of three position
streams (t, h, w: ``positions`` (3, B, S)), ``'sinusoidal'`` (MusicGen) is
added to the embeddings by ``models.transformer`` and ``'none'`` uses no
positions; the block rotates nothing for the last two.  ``qk_norm``
normalises q and k over the head dim (f32, eps 1e-6, the factor cast back to
their dtype, then the ``q_norm`` / ``k_norm`` scales) before the positions.

``ArchConfig.attn_impl`` picks the attention (the JAX package's
``attn_impl``, ``'pallas' | 'jnp'``):

- ``'flash'`` (default): ``kernels.flash_attention.flash_attention_train``,
  the forward, dQ and dK/dV kernels on the card (their plain versions on
  the CPU); no (S, S) tensor is kept for backward.
- ``'plain'``: ``gqa_attention``, the path the JAX package runs at model
  level (its q-chunked causal branch): einsum scores, the softcap
  ``tanh(s / cap) * cap`` when set, a mask with value ``-1e30``, an f32
  softmax cast to the input dtype, an einsum with V.

With a KV cache (serving), ``AttentionBlock`` keeps the JAX package's
``(k, v, kpos)`` cache, ``kpos`` holding the absolute position stored in
each slot (``KPOS_EMPTY`` where none is).  A prefill attends over its own
k/v (the flash forward kernel, or ``gqa_attention``, without autograd) and
then stores them; a decode step (one token) stores its k/v, then attends
over the whole cache with ``gqa_attention`` masked by ``kpos``, in torch
ops, as the JAX package computes decode attention outside any kernel.
The ring of a windowed layer is written **aligned**: slot ``p % T`` holds
position ``p`` in prefill and decode alike, so a decode step after any
prompt length sees exactly the keys the full forward does.  The JAX
prefill stores the trailing ``min(S, T)`` keys at slots ``0..``; the two
agree wherever ``S <= T`` or ``S % T == 0``, and elsewhere the JAX
decode overwrites a key still inside the window (a fact about the
reference; the port keeps the aligned ring on purpose).

The JAX blocks' ``constrain(...)`` sites are ``parallel.context.constrain``
calls at the same tensors: the identity off-context, a redistribution of a
DTensor under the dry run's context.  Under ``prefer='tp'`` the attention
block repeats K/V to the full head count before the heads shard over the
model axis, and under ``prefer='seq_tp'`` a self-attention prefill splits
its query rows into model-axis blocks (``gqa_attention``), as the JAX
layers do; neither changes a number.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention import flash_attention, flash_attention_train
from ..parallel.context import constrain, current, tp_active, tp_size
from ..parallel.sharding import is_dtensor
from .common import ArchConfig, Attention

ATTN_IMPLS = ("flash", "plain")
ROPES = ("rope", "mrope", "sinusoidal", "none")
NORMS = ("rmsnorm", "rmsnorm_gemma", "layernorm")
MLPS = ("swiglu", "geglu", "gelu")


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


@functools.cache
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # made once per device, so a CUDA graph captured later copies nothing from the host;
    # outside inference mode, so training may use it after serving
    with torch.inference_mode(False):
        return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)
    ang = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.cache
def _mrope_freqs_on(head_dim: int, theta: float, sections: tuple[int, int, int],
                    device: torch.device) -> torch.Tensor:
    # (3, hd/2): row k holds the frequencies of the half-dims that stream k rotates, 0
    # elsewhere (the JAX einsum operand); made once per device, as _rope_freqs_on
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to head_dim / 2 = {half}")
    sec = np.concatenate([np.full((s,), i) for i, s in enumerate(sections)])
    mask = (sec[None, :] == np.arange(3)[:, None]).astype(np.float32)
    with torch.inference_mode(False):
        return torch.as_tensor(mask * rope_freqs(head_dim, theta).astype(np.float32),
                               device=device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: (..., S, H, hd); positions (3, ..., S),
    the temporal / height / width streams.  The ``hd/2`` rotary frequencies
    are split into ``sections`` and each section turns by its stream's
    positions; for text the three streams are equal and this is
    ``apply_rope``."""
    sel = _mrope_freqs_on(x.shape[-1], theta, tuple(sections), x.device)
    # the JAX einsum 'k...s,kf->...sf' has no batch dimension; as a matmul it is one
    # aten.mm (torch.einsum would lower it to a bmm of batch 1), which remat='dots' saves
    ang = positions.float().movedim(0, -1) @ sel  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.cache
def sinusoidal_embedding(seq_len: int, dim: int, offset: int = 0,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """MusicGen's additive positions for ``offset .. offset + seq_len - 1``:
    (seq_len, dim) f32, the ``sin`` half then the ``cos`` half, base 10000,
    computed in f64 (the JAX ``sinusoidal_embedding``).  Made once per
    (length, offset, device): a CUDA graph captured later copies nothing from
    the host.  Made outside inference mode, so training may use it after
    serving."""
    pos = np.arange(offset, offset + seq_len, dtype=np.float64)[:, None]
    freqs = np.exp(-np.log(10000.0) * np.arange(0, dim, 2, dtype=np.float64) / dim)
    ang = pos * freqs[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)
    with torch.inference_mode(False):
        return torch.as_tensor(table, device=device)


def qk_rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The JAX block's ``qk_norm``: ``x * rsqrt(mean(x^2) + 1e-6)`` over the
    head dim, the factor computed in f32 and cast to x's dtype, times
    ``scale``."""
    inv = torch.rsqrt(torch.mean(torch.square(x.float()), dim=-1, keepdim=True) + 1e-6)
    return x * inv.to(x.dtype) * scale


KPOS_EMPTY = 2**30  # the position of a cache slot that holds no key (masked by causality)


def gqa_attention(
    q: torch.Tensor,  # (B, S, Hq, hd) — rope already applied
    k: torch.Tensor,  # (B, T, Hkv, hd)
    v: torch.Tensor,  # (B, T, Hkv, hd)
    *,
    window: int | None = None,
    softcap: float | None = None,
    q_chunk: int = 256,
    q_offset: torch.Tensor | int = 0,
    kpos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Query-chunked causal attention, over the last ``window`` keys of each
    query when given (``qpos - kpos < window``), with the scores capped at
    ``softcap`` when given; returns (B, S, Hq, hd).

    ``q_offset`` is the absolute position of ``q[:, 0]`` (an int or a 0-d
    tensor: a decode step's position lives on the device), ``kpos`` (T,)
    the absolute position of each key (a ring cache's slots; default
    ``0..T-1``).  q and k/v of different dtypes are promoted first, as
    ``jnp.einsum`` promotes them (bf16 queries over an f32 cache).

    Each chunk of ``q_chunk`` queries sees every key, so the softmax is
    the full row softmax; the chunking only bounds score memory.  Under a
    ``prefer='seq_tp'`` sharding context a self-attention prefill instead
    splits the rows into model-axis blocks (``_seq_tp_attention``)."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(B, S, Hkv, G, hd).to(dt)
    k, v = k.to(dt), v.to(dt)
    scale = hd ** -0.5
    if kpos is None:
        kpos = torch.arange(T, device=q.device)
    ctx = current()
    if ctx is not None and _seq_tp_applies(ctx, B, S, T, Hq):
        return _seq_tp_attention(qg, k, v, kpos, ctx.model_size, scale, window=window,
                                 softcap=softcap, q_offset=q_offset, out_dtype=q.dtype)

    def one_chunk(start: int, n: int) -> torch.Tensor:
        qs = qg[:, start : start + n]
        scores = torch.einsum("bskgh,btkh->bkgst", qs, k).float() * scale
        if softcap is not None:
            scores = torch.tanh(scores / softcap) * softcap
        qpos = q_offset + start + torch.arange(n, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        scores = scores.masked_fill(~mask, -1e30)
        p = torch.softmax(scores, dim=-1).to(q.dtype).to(dt)
        return torch.einsum("bkgst,btkh->bskgh", p, v)

    if S <= q_chunk:
        return one_chunk(0, S).reshape(B, S, Hq, hd)
    # a last, shorter chunk takes a length that q_chunk does not divide
    chunks = [one_chunk(s, min(q_chunk, S - s)) for s in range(0, S, q_chunk)]
    return torch.cat(chunks, dim=1).reshape(B, S, Hq, hd)


def _seq_tp_applies(ctx, B: int, S: int, T: int, Hq: int) -> bool:
    """The JAX rule for sequence-TP (a prefill on a non-EP arch leaves the
    model axis idle): a self-attention prefill whose length the model axis
    divides, and whose per-shard (S / model, T) f32 score block stays under
    8 GiB."""
    if ctx.prefer != "seq_tp" or ctx.model_axis is None or not ctx.batch_axes:
        return False
    seq_tp_bytes = max(1, B // ctx.data_size) * Hq * (S // ctx.model_size) * T * 4
    return S % ctx.model_size == 0 and S > 1 and S == T and 0 < seq_tp_bytes < 8 * 2**30


def _seq_tp_attention(qg, k, v, kpos, nc: int, scale: float, *, window, softcap, q_offset,
                      out_dtype):
    """Every one of ``nc`` row blocks (sharded over the model axis) against
    all the keys: the scores of the whole block at once, the same full-row
    softmax as the chunked path."""
    B, S, Hkv, G, hd = qg.shape
    T = k.shape[1]
    chunk = S // nc
    qb = constrain(qg.reshape(B, nc, chunk, Hkv, G, hd), {0: "batch", 1: "model"})
    scores = torch.einsum("bnckgh,btkh->bnkgct", qb, k).float() * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    qpos = (q_offset + (torch.arange(nc, device=qg.device) * chunk)[:, None]
            + torch.arange(chunk, device=qg.device)[None, :])  # (nc, chunk)
    mask = qpos[..., None] >= kpos[None, None, :]
    if window is not None:
        mask &= (qpos[..., None] - kpos[None, None, :]) < window
    scores = scores.masked_fill(~mask[None, :, None, None], -1e30)
    p = torch.softmax(scores, dim=-1).to(out_dtype).to(qg.dtype)
    o = torch.einsum("bnkgct,btkh->bnckgh", p, v)
    return o.reshape(B, S, Hkv * G, hd)


def write_rows(dst: torch.Tensor, dim: int, slots: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.index_copy_(dim, slots, src)`` for distinct ``slots``.  On a
    DTensor ``dst`` (the dry run's caches, their sequence dim sharded over
    the model axis) DTensor's in-place ``index_copy_`` would change the
    placement under the local shard, so each shard writes the slots it owns
    in a ``local_map`` region instead (``src`` replicated along ``dim``
    first); a single slot (decode) reads and writes one row per shard."""
    if not is_dtensor(dst):
        dst.index_copy_(dim, slots, src)
        return
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = dst.device_mesh, tuple(dst.placements)
    size, offset = dst.shape[dim], 0
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):  # nested shards of dim, major to minor
        if p.is_shard(dim):
            size //= mesh.size(i)
            offset += coord[i] * size

    def write(local, rows, slots):
        loc = slots.to(torch.long) - offset
        if slots.numel() == 1:
            owned = (loc >= 0) & (loc < size)
            at = loc.clamp(0, size - 1)
            shape = [1] * local.dim()
            shape[dim] = 1
            old = local.index_select(dim, at)
            local.index_copy_(dim, at, torch.where(owned.reshape(shape), rows.to(local.dtype), old))
            return
        inv = torch.full((max(int(dst.shape[dim]), 1),), -1, dtype=torch.long, device=local.device)
        inv[slots.to(torch.long)] = torch.arange(slots.numel(), device=local.device)
        which = inv[offset : offset + size]  # the row of src each owned slot takes, -1: none
        shape = [1] * local.dim()
        shape[dim] = size
        new = rows.index_select(dim, which.clamp(min=0)).to(local.dtype)
        local.copy_(torch.where((which >= 0).reshape(shape), new, local))

    src_pl = tuple(Replicate() if p.is_shard(dim) else p for p in pl)
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    local_map(write, out_placements=None, in_placements=(pl, src_pl, None), device_mesh=mesh,
              redistribute_inputs=True)(dst, src, slots)


class AttentionBlock(nn.Module):
    """``{'wq', 'wk', 'wv', 'wo'}`` (and ``'q_norm'``, ``'k_norm'`` (hd,) with
    ``att.qk_norm``): project, norm q and k (``qk_norm``), apply the
    positions (``att.rope``: ``positions`` is (B, S), or (3, B, S) for
    ``'mrope'``), attend (causal, over the last ``window`` keys when given,
    under ``att.softcap``), out-project.

    ``forward(x, positions, kv_cache=None, q_offset=0)`` returns ``(out,
    new_cache)``.  Without a cache (training) new_cache is None.  With one,
    ``kv_cache`` is ``(k, v, kpos)``: k and v (B, T, Hkv, hd), kpos (T,)
    int32; the block writes them in place and returns the same tensors.
    A prefill (S > 1) starts at ``q_offset`` 0 and attends over its own
    k/v; a decode step (S == 1) attends over the cache at position
    ``q_offset`` (an int or a 0-d device tensor), which a full-causal
    cache writes at slot ``min(q_offset, T - 1)``, as the JAX
    ``dynamic_update_slice`` clamps it."""

    def __init__(self, cfg: ArchConfig, att: Attention, device=None, window: int | None = None):
        super().__init__()
        if cfg.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {cfg.attn_impl!r}")
        d = cfg.d_model
        qd, kvd = att.n_heads * att.head_dim, att.n_kv_heads * att.head_dim
        mk = lambda *shape: nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))
        self.wq, self.wk, self.wv, self.wo = mk(d, qd), mk(d, kvd), mk(d, kvd), mk(qd, d)
        if att.qk_norm:
            self.q_norm, self.k_norm = mk(att.head_dim), mk(att.head_dim)
        self.cfg, self.att, self.window = cfg, att, window

    def _qk_positions(self, q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor):
        att = self.att
        if att.qk_norm:
            q, k = qk_rms_norm(q, self.q_norm), qk_rms_norm(k, self.k_norm)
        if att.rope == "rope":
            return apply_rope(q, positions, att.rope_theta), apply_rope(k, positions, att.rope_theta)
        if att.rope == "mrope":
            return (apply_mrope(q, positions, att.rope_theta, att.mrope_sections),
                    apply_mrope(k, positions, att.rope_theta, att.mrope_sections))
        return q, k  # 'sinusoidal' is added to the embeddings; 'none' is NoPE

    def forward(self, x: torch.Tensor, positions: torch.Tensor, kv_cache=None,
                q_offset: torch.Tensor | int = 0):
        att = self.att
        B, S, _ = x.shape
        x = constrain(x, {0: "batch"})
        q = constrain((x @ self.wq).reshape(B, S, att.n_heads, att.head_dim),
                      {0: "batch", 2: "model"})
        k = (x @ self.wk).reshape(B, S, att.n_kv_heads, att.head_dim)
        v = (x @ self.wv).reshape(B, S, att.n_kv_heads, att.head_dim)
        if tp_active() and kv_cache is None and att.n_heads % tp_size() == 0:
            # TP: K/V at the full head count, so the (KV, G) split never
            # fights the head sharding (Megatron-style, G x the K/V reads)
            grp = att.n_heads // att.n_kv_heads
            k, v = k.repeat_interleave(grp, dim=2), v.repeat_interleave(grp, dim=2)
        k = constrain(k, {0: "batch", 2: "model"})
        v = constrain(v, {0: "batch", 2: "model"})
        q, k = self._qk_positions(q, k, positions)
        if kv_cache is not None:
            return self._cached(x, q, k, v, kv_cache, q_offset)
        if self.cfg.attn_impl == "flash":
            o = flash_attention_train(q, k, v, causal=True, window=self.window,
                                      softcap=att.softcap)
        else:
            o = gqa_attention(q, k, v, window=self.window, softcap=att.softcap,
                              q_chunk=self.cfg.q_chunk)
        return constrain(o.reshape(B, S, -1).to(x.dtype) @ self.wo, {0: "batch"}), None

    def _cached(self, x, q, k, v, kv_cache, q_offset):
        ck, cv, ckpos = kv_cache
        B, S, _ = x.shape
        Tc = ck.shape[1]
        att = self.att
        if S == 1:  # decode: store this token's k/v, attend over the cache
            pos = torch.as_tensor(q_offset, device=x.device).reshape(1).long()
            idx = pos % Tc if self.window else torch.clamp(pos, max=Tc - 1)
            write_rows(ck, 1, idx, k.to(ck.dtype))
            write_rows(cv, 1, idx, v.to(cv.dtype))
            write_rows(ckpos, 0, idx, pos.to(ckpos.dtype))
            o = gqa_attention(q, ck, cv, window=self.window, softcap=att.softcap,
                              q_chunk=self.cfg.q_chunk, q_offset=q_offset, kpos=ckpos)
        else:  # prefill: attend over its own k/v, then store the window's keys
            if not isinstance(q_offset, int) or q_offset != 0:
                raise ValueError("a prefill starts at position 0")
            if self.cfg.attn_impl == "flash":
                o = flash_attention(q, k, v, causal=True, window=self.window,
                                    softcap=att.softcap)
            else:
                o = gqa_attention(q, k, v, window=self.window, softcap=att.softcap,
                                  q_chunk=self.cfg.q_chunk)
            keep = min(S, Tc)
            pos = torch.arange(S - keep, S, device=x.device)
            slot = pos % Tc  # aligned: slot p % Tc holds position p
            write_rows(ck, 1, slot, k[:, S - keep:].to(ck.dtype))
            write_rows(cv, 1, slot, v[:, S - keep:].to(cv.dtype))
            ckpos.fill_(KPOS_EMPTY)
            write_rows(ckpos, 0, slot, pos.to(ckpos.dtype))
        return constrain(o.reshape(B, S, -1).to(x.dtype) @ self.wo, {0: "batch"}), (ck, cv, ckpos)


class MLP(nn.Module):
    """SwiGLU ``silu(x @ w_gate) * (x @ w_up) @ w_down``, GeGLU with the
    tanh-approximated GeLU in place of SiLU, or the plain GeLU MLP
    ``gelu_tanh(x @ w_up) @ w_down``, which has no ``w_gate``
    (``cfg.mlp``)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        mk = lambda *shape: nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))
        if cfg.mlp != "gelu":
            self.w_gate = mk(d, f)
        self.w_up, self.w_down = mk(d, f), mk(f, d)
        self.kind = cfg.mlp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Megatron-style TP under a context: the hidden dim shards over
        # 'model', and w_down's contraction reduces over it
        x = constrain(x, {0: "batch"})
        tp = {0: "batch", 2: "model"}
        if self.kind == "gelu":
            h = constrain(F.gelu(x @ self.w_up, approximate="tanh"), tp)
        else:
            z = x @ self.w_gate
            act = F.gelu(z, approximate="tanh") if self.kind == "geglu" else F.silu(z)
            h = constrain(act, tp) * constrain(x @ self.w_up, tp)
        return constrain(h @ self.w_down, {0: "batch"})


def softcap_logits(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    """``tanh(logits / cap) * cap``, or ``logits`` when ``cap`` is None."""
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap
