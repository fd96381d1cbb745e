"""Plain PyTorch versions of the WKV6 kernels (counterpart of
``repro/kernels/rwkv6_wkv/ref.py``).

The recurrence, per batch row b and head h, over a (K, K) state S from
``s0`` (zero when absent), with inputs (B, T, H, K) and the bonus ``u``
(H, K)::

    out_t = r_t · S + (r_t · (u ⊙ k_t)) v_t
    S    <- diag(w_t) · S + k_tᵀ v_t

``w`` is the decay, in (0, 1).  Everything is computed in f32 (in f64 for
f64 inputs, which the gradient checks use), whatever the input dtype.

- ``wkv_ref``: the sequential loop, the forward kernel's plain version;
  returns ``out`` (B, T, H, K) and ``s_final`` (B, H, K, K).
- ``wkv_chunked_ref``: the forward kernels' own arithmetic, step for step
  (chunks of 64 steps cut into sub-chunks of 8, exponents built from
  prefix, suffix and sub-chunk-total pieces of the floored log decay,
  never a difference of two cumulative sums); it mirrors the kernel on
  the CPU and is held to ``wkv_ref``.
- ``wkv_bwd_ref``: the gradient, written out step by step.  With ``dS_t``
  the gradient with respect to the state after step t
  (``dS_{T-1} = ds_final``, zero when absent) and ``S_{t-1}`` the state
  before step t::

      dv_t[v]  = Σ_k dS_t[k,v] k_t[k]     + (r_t·(u⊙k_t)) do_t[v]
      dk_t[k]  = Σ_v dS_t[k,v] v_t[v]     + u[k] r_t[k] (do_t·v_t)
      dr_t[k]  = Σ_v S_{t-1}[k,v] do_t[v] + u[k] k_t[k] (do_t·v_t)
      dw_t[k]  = Σ_v dS_t[k,v] S_{t-1}[k,v]
      du[h,k]  = Σ_{b,t} r_t[k] k_t[k] (do_t·v_t)
      dS_{t-1} = diag(w_t) dS_t + r_tᵀ do_t ;   ds0 = dS_{-1}

  The reverse walk needs ``S_{t-1}``; it keeps the state at every
  ~sqrt(T)-th step of a forward walk and recomputes one chunk's states at
  a time (never ``(S_t - k_tᵀv_t) / w_t``, which is unstable).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: Floor of the log decay: a w that underflowed to 0 decays by e^-88 (below
#: f32's normal range) instead of giving log 0 - log 0.
LW_FLOOR = -88.0
#: Steps per chunk and per sub-chunk of the forward kernels (``kL`` and ``kSub``
#: of ``csrc/rwkv6_wkv.cu``; the wrapper checks both when it loads the library).
CHUNK, SUB = 64, 8


def _dtype(*tensors: torch.Tensor | None) -> torch.dtype:
    dt = torch.float32
    for t in tensors:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return dt


def _step(S: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """S (B, H, K, K) -> diag(w_t) S + k_tᵀ v_t."""
    return S * w_t[..., None] + k_t[..., :, None] * v_t[..., None, :]


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, s0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV6: ``out`` (B, T, H, K) and ``s_final`` (B, H, K, K)."""
    dt = _dtype(r, k, v, w, u, s0)
    rf, kf, vf, wf, uf = (a.to(dt) for a in (r, k, v, w, u))
    B, T, H, K = r.shape
    S = torch.zeros(B, H, K, K, dtype=dt, device=r.device) if s0 is None else s0.to(dt)
    bonus = torch.sum(rf * uf * kf, dim=-1, keepdim=True) * vf  # (B, T, H, K)
    outs = []
    for t in range(T):
        outs.append((rf[:, t, :, None, :] @ S)[..., 0, :] + bonus[:, t])
        S = _step(S, kf[:, t], vf[:, t], wf[:, t])
    return torch.stack(outs, dim=1), S


def wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                u: torch.Tensor, s0: torch.Tensor | None, dout: torch.Tensor,
                ds_final: torch.Tensor | None = None):
    """Gradient of ``wkv_ref``: (dr, dk, dv, dw, du, ds0), f32 (f64 for f64
    inputs); ds0 is None when ``s0`` is None, and ``ds_final`` None means
    zero."""
    dt = _dtype(r, k, v, w, u, s0, dout, ds_final)
    rf, kf, vf, wf, uf, df = (a.to(dt) for a in (r, k, v, w, u, dout))
    B, T, H, K = r.shape
    chunk = max(1, math.isqrt(T))  # spacing of the kept states
    S = torch.zeros(B, H, K, K, dtype=dt, device=r.device) if s0 is None else s0.to(dt)
    kept = []  # kept[c] = the state before step c * chunk
    for t in range(T):
        if t % chunk == 0:
            kept.append(S)
        S = _step(S, kf[:, t], vf[:, t], wf[:, t])

    dov = torch.sum(df * vf, dim=-1, keepdim=True)  # (B, T, H, 1)
    bonus = torch.sum(rf * uf * kf, dim=-1, keepdim=True)
    dr, dk, dv, dw = (torch.empty(B, T, H, K, dtype=dt, device=r.device) for _ in range(4))
    dS = torch.zeros(B, H, K, K, dtype=dt, device=r.device) if ds_final is None else ds_final.to(dt)
    for c in range(len(kept) - 1, -1, -1):
        t0, t1 = c * chunk, min(T, (c + 1) * chunk)
        prev = [kept[c]]  # prev[i] = S_{t0 + i - 1}
        for t in range(t0, t1 - 1):
            prev.append(_step(prev[-1], kf[:, t], vf[:, t], wf[:, t]))
        for t in range(t1 - 1, t0 - 1, -1):
            S_prev = prev[t - t0]
            dv[:, t] = (kf[:, t, :, None, :] @ dS)[..., 0, :] + bonus[:, t] * df[:, t]
            dk[:, t] = (dS @ vf[:, t, :, :, None])[..., 0] + uf * rf[:, t] * dov[:, t]
            dr[:, t] = (S_prev @ df[:, t, :, :, None])[..., 0] + uf * kf[:, t] * dov[:, t]
            dw[:, t] = torch.sum(dS * S_prev, dim=-1)
            dS = dS * wf[:, t][..., None] + rf[:, t][..., :, None] * df[:, t][..., None, :]
    du = torch.sum(rf * kf * dov, dim=(0, 1))
    return dr, dk, dv, dw, du, (None if s0 is None else dS)


def _running(x: torch.Tensor, dim: int, reverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Exclusive running sums of ``x`` along ``dim``, one addition at a time
    (forward: the sum of the elements before each; reverse: of those after
    it), and the total."""
    n = x.shape[dim]
    acc = torch.zeros_like(x.select(dim, 0))
    out = [None] * n
    for s in (range(n - 1, -1, -1) if reverse else range(n)):
        out[s] = acc
        acc = acc + x.select(dim, s)
    return torch.stack(out, dim=dim), acc


def wkv_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    u: torch.Tensor, s0: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked WKV6 that the forward kernels compute: ``out`` (B, T, H, K)
    and ``s_final`` (B, H, K, K), in f32 (f64 for f64 inputs).

    With ``lw = max(log w, -88)`` (0 past T) and ``P(a, b) = Σ_{a<=m<b} lw_m``
    over a chunk's local steps (chunks of ``CHUNK`` steps in sub-chunks of
    ``SUB``), a chunk that starts at state S_c gives::

        out_i   = r_i·(e^{P(0,i)} ⊙ S_c) + Σ_{j<i} [Σ_k r_i k_j e^{P(j+1,i)}] v_j
                  + (r_i·(u⊙k_i)) v_i
        S_{c+1} = e^{P(0,n)} ⊙ S_c + Σ_j (k_j ⊙ e^{P(j+1,n)})ᵀ v_j

    Every exponent is a sum of pieces that never cancel: within a
    sub-chunk the exclusive prefix ``pre`` and suffix ``suf``, and whole
    sub-chunk totals ``tot`` (summed in increasing order):
    - the state term: ``r_i e^{before_I + pre_i}``, before_I the totals of
      the sub-chunks before I;
    - a pair of sub-chunks I > J: ``(r_i e^{pre_i + between_JI}) · (k_j
      e^{suf_j})``, between_JI the totals strictly between them;
    - j < i in one sub-chunk: a running sum of lw from i-1 down to j+1;
    - the state update: ``k_j e^{suf_j + after_J}``, after_J the totals of
      the sub-chunks after J, and the decay ``e^{Σ tot}``.
    Nothing divides by a cumulative decay, so it holds for any w in [0, 1).
    """
    chunk, sub = CHUNK, SUB
    dt = _dtype(r, k, v, w, u, s0)
    B, T, H, K = r.shape
    NC, NS = -(-T // chunk), chunk // sub
    pad = NC * chunk - T

    def blocks(a: torch.Tensor) -> torch.Tensor:  # (B, T, H, K) -> (B, H, NC, NS, sub, K)
        a = F.pad(a, (0, 0, 0, 0, 0, pad))
        return a.reshape(B, NC, NS, sub, H, K).permute(0, 4, 1, 2, 3, 5)

    rb, kb, vb = (blocks(a.to(dt)) for a in (r, k, v))
    lw = blocks(torch.clamp(torch.log(w.to(dt)), min=LW_FLOOR))  # padded steps: 0
    uf = u.to(dt)[None, :, None, :]  # (1, H, 1, K)
    pre, tot = _running(lw, dim=4)  # (B, H, NC, NS, sub, K), (B, H, NC, NS, K)
    suf, _ = _running(lw, dim=4, reverse=True)

    def totals(c: int, first: int, last: int) -> torch.Tensor:  # Σ_{first<=M<last} tot_M
        acc = torch.zeros_like(tot[:, :, c, 0])
        for m in range(first, last):
            acc = acc + tot[:, :, c, m]
        return acc

    S = torch.zeros(B, H, K, K, dtype=dt, device=r.device) if s0 is None else s0.to(dt)
    tri = torch.arange(sub, device=r.device)
    outs = []
    for c in range(NC):
        rc, kc, vc, lc, pc, sc = (a[:, :, c] for a in (rb, kb, vb, lw, pre, suf))
        before = torch.stack([totals(c, 0, i) for i in range(NS)], dim=2)  # (B, H, NS, K)
        after = torch.stack([totals(c, j + 1, NS) for j in range(NS)], dim=2)
        rs = (rc * torch.exp(before[:, :, :, None] + pc)).reshape(B, H, chunk, K)
        out = rs @ S
        A = torch.zeros(B, H, NS, NS, sub, sub, dtype=dt, device=r.device)
        for i in range(NS):
            for j in range(i):
                rp = rc[:, :, i] * torch.exp(pc[:, :, i] + totals(c, j + 1, i)[:, :, None])
                kh = kc[:, :, j] * torch.exp(sc[:, :, j])
                A[:, :, i, j] = rp @ kh.transpose(-1, -2)
        run = torch.zeros_like(lc)  # run[i] = Σ lw from i-1 down to i-d+1
        diag = torch.zeros(B, H, NS, sub, sub, dtype=dt, device=r.device)
        for d in range(1, sub):
            if d > 1:
                run[..., d:, :] = run[..., d:, :] + lc[..., 1:sub - d + 1, :]
            vals = torch.sum(rc[..., d:, :] * kc[..., :sub - d, :] * torch.exp(run[..., d:, :]),
                             dim=-1)
            diag[..., tri[d:], tri[:sub - d]] = vals
        diag[..., tri, tri] = torch.sum(rc * uf[:, :, None] * kc, dim=-1)  # the bonus
        A[:, :, tri[:NS], tri[:NS]] = diag
        A = A.permute(0, 1, 2, 4, 3, 5).reshape(B, H, chunk, chunk)
        outs.append(out + A @ vc.reshape(B, H, chunk, K))
        kt = (kc * torch.exp(sc + after[:, :, :, None])).reshape(B, H, chunk, K)
        S = torch.exp(totals(c, 0, NS))[..., :, None] * S + kt.transpose(-1, -2) @ vc.reshape(
            B, H, chunk, K)
    out = torch.stack(outs, dim=2).reshape(B, H, NC * chunk, K).permute(0, 2, 1, 3)
    return out[:, :T].contiguous(), S
