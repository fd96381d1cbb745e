"""Plain PyTorch versions of the flash-attention kernels (counterparts of
``repro/kernels/flash_attention/ref.py`` and of the formulas of its
``kernel.py`` and ``kernel_bwd.py``).

Layouts are the JAX package's: q and o are (B, Sq, Hq, hd), k and v are
(B, Sk, Hkv, hd), and ``lse`` and ``delta`` are (B, Sq, Hq).  Query head h
reads KV head h // G with G = Hq // Hkv.  Everything is computed densely
in f32 and cast back to the input dtype at the end.

``attention_ref`` is the dense oracle: a ``-inf`` mask, a softmax and
NaN -> 0 for rows that see no key.  The ``flash_*`` functions follow the
kernels' formulas instead: the forward returns the row logsumexp ``lse``
beside ``o``, and the backward recomputes ``p = exp(s - lse)`` under the
mask, with ``delta = rowsum(dO * o)``, the softcap factor ``1 - t^2``,
the scale ``hd**-0.5`` and dK/dV summed over the G query heads of each KV
head.  A row that sees no key gets ``o = 0`` and ``lse = -1e30``, as
``attention_ref`` has it.  (The Pallas forward gives such a row the mean
of the visible block's values: its -1e30 mask value turns into
``exp(0) = 1`` weights.  Square causal attention never has such a row.)
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(sq: int, sk: int, causal: bool, window: int | None, q_offset: int,
          device: torch.device) -> torch.Tensor:
    """(Sq, Sk) bool: which key each query row sees."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, softcap: float | None):
    """f32 scores (B, Hkv, G, Sq, Sk) and d(score)/d(scaled dot) (None
    without softcap)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) * hd**-0.5
    if softcap is None:
        return s, None
    t = torch.tanh(s / softcap)
    return t * softcap, 1.0 - t * t


def _rows(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Sq, Hq) row statistic -> (B, Hkv, G, Sq, 1) to broadcast over keys."""
    B, Sq, Hq = x.shape
    return x.float().reshape(B, Sq, hkv, Hq // hkv).permute(0, 2, 3, 1)[..., None]


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Dense masked softmax attention with GQA; (B, Sq, Hq, hd) in q's dtype."""
    B, Sq, Hq, hd = q.shape
    s, _ = _scores(q, k, softcap)
    mask = _mask(Sq, k.shape[1], causal, window, q_offset, q.device)
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # rows that see no key
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


def flash_attention_fwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): o (B, Sq, Hq, hd) in q's dtype, lse (B, Sq, Hq) f32."""
    B, Sq, Hq, hd = q.shape
    s, _ = _scores(q, k, softcap)
    mask = _mask(Sq, k.shape[1], causal, window, 0, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)  # NEG_INF for a row that sees no key
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float()) / torch.where(
        l == 0.0, 1.0, l
    ).permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]  # (B, Hkv, G, Sq)
    return (o.reshape(B, Sq, Hq, hd).to(q.dtype),
            lse.reshape(B, Hq, Sq).transpose(1, 2).contiguous())


def _probs_and_dscores(q, k, v, do, lse, delta, causal, window, softcap):
    """p = exp(s - lse) under the mask and ds = p (dO v^T - delta) (1 - t^2)
    hd^-1/2, both (B, Hkv, G, Sq, Sk) f32, and dO as (B, Sq, Hkv, G, hd) f32."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    s, dcap = _scores(q, k, softcap)
    mask = _mask(Sq, k.shape[1], causal, window, 0, q.device)
    p = torch.where(mask, torch.exp(s - _rows(lse, Hkv)), 0.0)
    dof = do.float().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    dp = torch.einsum("bskgh,btkh->bkgst", dof, v.float())
    ds = p * (dp - _rows(delta, Hkv))
    if dcap is not None:
        ds = ds * dcap
    return p, ds * hd**-0.5, dof


def flash_attention_dq_ref(q, k, v, do, lse, delta, *, causal=True, window=None,
                           softcap=None) -> torch.Tensor:
    """dQ (B, Sq, Hq, hd) in q's dtype, from the forward's ``lse`` and
    ``delta = rowsum(dO * o)``."""
    _, ds, _ = _probs_and_dscores(q, k, v, do, lse, delta, causal, window, softcap)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, delta, *, causal=True, window=None,
                            softcap=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), each (B, Sk, Hkv, hd) in k's and v's dtype: the per query
    head gradients summed over the G heads of each KV head."""
    B, Sq, Hq, hd = q.shape
    p, ds, dof = _probs_and_dscores(q, k, v, do, lse, delta, causal, window, softcap)
    qf = q.float().reshape(B, Sq, k.shape[2], Hq // k.shape[2], hd)
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qf)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * o)`` in f32, (B, Sq, Hq): the backward's row term."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=None,
                            softcap=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the forward that returned ``o`` and ``lse``."""
    delta = attention_delta(o, do)
    opts = dict(causal=causal, window=window, softcap=softcap)
    dq = flash_attention_dq_ref(q, k, v, do, lse, delta, **opts)
    dk, dv = flash_attention_dkv_ref(q, k, v, do, lse, delta, **opts)
    return dq, dk, dv
