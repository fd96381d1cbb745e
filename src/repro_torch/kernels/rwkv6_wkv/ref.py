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
  a time.  dw is the product of the two states itself: recovering
  ``S_{t-1}`` as ``(S_t - k_tᵀv_t) / w_t``, or dw as ``d(log w) / w``,
  divides by the decay and is wrong wherever w is small.
- ``wkv_bwd_chunked_ref``: the backward kernels' own arithmetic, in the
  same chunks and pieces as the forward's, nothing divided by a decay
  (see its docstring); held to ``wkv_bwd_ref``.
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


def _blocks(a: torch.Tensor, NC: int) -> torch.Tensor:
    """(B, T, H, K) -> (B, H, NC, NS, SUB, K), zero past T."""
    B, T, H, K = a.shape
    a = F.pad(a, (0, 0, 0, 0, 0, NC * CHUNK - T))
    return a.reshape(B, NC, CHUNK // SUB, SUB, H, K).permute(0, 4, 1, 2, 3, 5)


def _unblocks(x: torch.Tensor, T: int) -> torch.Tensor:
    """(B, H, NC, CHUNK, K) -> (B, T, H, K)."""
    B, H, NC, n, K = x.shape
    return x.reshape(B, H, NC * n, K).permute(0, 2, 1, 3)[:, :T].contiguous()


def _reversed_chunks(a: torch.Tensor) -> torch.Tensor:
    """(B, T, H, K) with the steps of each chunk in reverse order, the chunk
    grid kept (the last, ragged chunk reversed over its own steps); its own
    inverse."""
    T = a.shape[1]
    t = torch.arange(T, device=a.device)
    first = t - t % CHUNK
    n = torch.clamp(T - first, max=CHUNK)
    return a[:, first + n - 1 - t % CHUNK]


def _pieces(lc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A chunk's (B, H, NS, SUB, K) log decays -> the exclusive prefix ``pre``
    and suffix ``suf`` within each sub-chunk, and the sub-chunk totals
    ``tot`` (B, H, NS, K)."""
    pre, tot = _running(lc, dim=3)
    suf, _ = _running(lc, dim=3, reverse=True)
    return pre, suf, tot


def _totals(tot: torch.Tensor, first: int, last: int) -> torch.Tensor:
    """Σ_{first<=M<last} tot_M, in increasing M (0 when empty)."""
    acc = torch.zeros_like(tot[:, :, 0])
    for m in range(first, last):
        acc = acc + tot[:, :, m]
    return acc


def _chunk_out(rc, kc, vc, lc, uk, S):
    """One chunk's outputs (B, H, CHUNK, K) from its state S (B, H, K, K):
    ``r_i·(e^{P(0,i)} ⊙ S) + Σ_{j<i} A_ij v_j + (r_i·(u⊙k_i)) v_i``, the
    inputs (B, H, NS, SUB, K), ``uk`` (1, H, K)."""
    B, H, NS, sub, K = rc.shape
    pc, sc, tot = _pieces(lc)
    before = torch.stack([_totals(tot, 0, i) for i in range(NS)], dim=2)  # (B, H, NS, K)
    rs = (rc * torch.exp(before[:, :, :, None] + pc)).reshape(B, H, NS * sub, K)
    out = rs @ S
    A = torch.zeros(B, H, NS, NS, sub, sub, dtype=rc.dtype, device=rc.device)
    for i in range(NS):
        for j in range(i):
            rp = rc[:, :, i] * torch.exp(pc[:, :, i] + _totals(tot, j + 1, i)[:, :, None])
            kh = kc[:, :, j] * torch.exp(sc[:, :, j])
            A[:, :, i, j] = rp @ kh.transpose(-1, -2)
    tri = torch.arange(sub, device=rc.device)
    run = torch.zeros_like(lc)  # run[i] = Σ lw from i-1 down to i-d+1
    diag = torch.zeros(B, H, NS, sub, sub, dtype=rc.dtype, device=rc.device)
    for d in range(1, sub):
        if d > 1:
            run[..., d:, :] = run[..., d:, :] + lc[..., 1:sub - d + 1, :]
        vals = torch.sum(rc[..., d:, :] * kc[..., :sub - d, :] * torch.exp(run[..., d:, :]),
                         dim=-1)
        diag[..., tri[d:], tri[:sub - d]] = vals
    diag[..., tri, tri] = torch.sum(rc * uk[:, :, None, None] * kc, dim=-1)  # the bonus
    A[:, :, tri[:NS], tri[:NS]] = diag
    A = A.permute(0, 1, 2, 4, 3, 5).reshape(B, H, NS * sub, NS * sub)
    return out + A @ vc.reshape(B, H, NS * sub, K)


def _chunk_state(kc, vc, lc, S):
    """The state after a chunk from the state S before it:
    ``e^{P(0,n)} ⊙ S + Σ_j (k_j ⊙ e^{P(j+1,n)})ᵀ v_j``."""
    B, H, NS, sub, K = kc.shape
    _, sc, tot = _pieces(lc)
    after = torch.stack([_totals(tot, j + 1, NS) for j in range(NS)], dim=2)
    kt = (kc * torch.exp(sc + after[:, :, :, None])).reshape(B, H, NS * sub, K)
    return torch.exp(_totals(tot, 0, NS))[..., :, None] * S + kt.transpose(-1, -2) @ vc.reshape(
        B, H, NS * sub, K)


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
    dt = _dtype(r, k, v, w, u, s0)
    B, T, H, K = r.shape
    NC = -(-T // CHUNK)
    rb, kb, vb = (_blocks(a.to(dt), NC) for a in (r, k, v))
    lb = _blocks(torch.clamp(torch.log(w.to(dt)), min=LW_FLOOR), NC)  # padded steps: 0
    uk = u.to(dt)[None]
    S = torch.zeros(B, H, K, K, dtype=dt, device=r.device) if s0 is None else s0.to(dt)
    outs = []
    for c in range(NC):
        outs.append(_chunk_out(rb[:, :, c], kb[:, :, c], vb[:, :, c], lb[:, :, c], uk, S))
        S = _chunk_state(kb[:, :, c], vb[:, :, c], lb[:, :, c], S)
    return _unblocks(torch.stack(outs, dim=2), T), S


def _chunk_grads(rc, kc, vc, dc, wc, lc, uk, S, dS):
    """dr, dk, dw (B, H, CHUNK, K) and the du partial (B, H, K) of one chunk
    from its state S before it and the cotangent dS after it (B, H, K, K)."""
    B, H, NS, sub, K = rc.shape
    flat = lambda a: a.reshape(B, H, NS * sub, K)
    M = (flat(dc) @ flat(vc).transpose(-1, -2)).reshape(B, H, NS, sub, NS, sub)  # do_i·v_j
    Hs = (flat(dc) @ S.transpose(-1, -2)).reshape(B, H, NS, sub, K)  # S do_t
    Gs = (flat(vc) @ dS.transpose(-1, -2)).reshape(B, H, NS, sub, K)  # dS v_t
    c0 = torch.sum(dS * S, dim=-1)
    pre, suf, tot = _pieces(lc)
    rh, kh = rc * torch.exp(pre), kc * torch.exp(suf)
    e = lambda first, last: torch.exp(_totals(tot, first, last))[:, :, None]  # (B, H, 1, K)

    # the cross-sub-chunk sums: Xc (S at the start of I times do_i), Zc (dS at
    # the end of I times v_j), and W[J, L] = Σ_{j∈J, i∈L} rh_i kh_j (do_i·v_j)
    PK, Xc, Zc = {}, [], []
    for I in range(NS):
        x = e(0, I) * Hs[:, :, I]
        for J in range(I):
            PK[I, J] = M[:, :, I, :, J, :] @ kh[:, :, J]
            x = x + e(J + 1, I) * PK[I, J]
        Xc.append(x)
        z = e(I + 1, NS) * Gs[:, :, I]
        for L in range(I + 1, NS):
            z = z + e(I + 1, L) * (M[:, :, L, :, I, :].transpose(-1, -2) @ rh[:, :, L])
        Zc.append(z)
    # W[J, L] with J = -1 for S_c and L = NS for dS
    W = {(-1, NS): c0}
    for L in range(1, NS):
        W[-1, L] = torch.sum(rh[:, :, L] * Hs[:, :, L], dim=2)
        for J in range(L - 1):
            W[J, L] = torch.sum(rh[:, :, L] * PK[L, J], dim=2)
    for J in range(NS - 1):
        W[J, NS] = torch.sum(kh[:, :, J] * Gs[:, :, J], dim=2)

    dr, dk, dw = (torch.zeros(B, H, NS, sub, K, dtype=rc.dtype, device=rc.device)
                  for _ in range(3))
    du = torch.zeros(B, H, K, dtype=rc.dtype, device=rc.device)
    for I in range(NS):
        # phi = Σ_v dS_I ⊙ S_{t-1}, dS_I the cotangent at the end of I; at t = start of I
        phi = torch.zeros_like(c0)
        for J in range(-1, I):
            inner = e(I + 1, NS)[:, :, 0] * W[J, NS]
            for L in range(I + 1, NS):
                inner = inner + e(I + 1, L)[:, :, 0] * W[J, L]
            phi = phi + e(J + 1, I)[:, :, 0] * inner
        m = M[:, :, I, :, I, :]
        Y = list(Xc[I].unbind(2))  # Y[i] = S_{t-1} do_i, walked through I
        du_I = torch.zeros_like(c0)
        for s in range(sub):
            r_s, k_s, w_s = rc[:, :, I, s], kc[:, :, I, s], wc[:, :, I, s]
            mss = m[..., s, s][..., None]
            zy, zm = torch.zeros_like(c0), torch.zeros_like(c0)
            for i in range(sub - 1, s, -1):  # Σ_{i>s} r_i Π_{s<m<i} w_m (Horner)
                zy = rc[:, :, I, i] * Y[i] + wc[:, :, I, i] * zy
                zm = rc[:, :, I, i] * m[..., i, s][..., None] + wc[:, :, I, i] * zm
            es = torch.exp(suf[:, :, I, s])
            dr[:, :, I, s] = Y[s] + uk * k_s * mss
            dw[:, :, I, s] = es * phi + zy
            dk[:, :, I, s] = es * Zc[I][:, :, s] + zm + uk * r_s * mss
            du_I = du_I + r_s * k_s * mss
            phi = w_s * phi + k_s * Zc[I][:, :, s]
            for i in range(s + 1, sub):
                Y[i] = w_s * Y[i] + k_s * m[..., i, s][..., None]
        du = du + du_I
    return tuple(a.reshape(B, H, NS * sub, K) for a in (dr, dk, dw)) + (du,)


def wkv_bwd_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                        u: torch.Tensor, s0: torch.Tensor | None, dout: torch.Tensor,
                        ds_final: torch.Tensor | None = None):
    """The gradient of ``wkv_chunked_ref`` as the backward kernels compute it:
    (dr, dk, dv, dw, du, ds0), f32 (f64 for f64 inputs); ds0 is None when
    ``s0`` is None.  Notation as there; S_c is the state at the start of
    chunk c and dS_{c+1} the cotangent at its end (ds_final after the last).

    - The chunk states S_c: the forward's walk.
    - The cotangents: ``dS_c = e^{P(0,n)} ⊙ dS_{c+1} + Σ_i (r_i ⊙
      e^{P(0,i)})ᵀ do_i``, from ds_final back to ds0 = dS_0.  This is the
      forward's state update run backward in time: each chunk's steps in
      reverse order, r in k's place and do in v's.
    - dv: ``(k_t ⊙ e^{P(t+1,n)}) dS_{c+1} + Σ_{i>t} A_it do_i + (k_t·(u⊙r_t))
      do_t``, A the forward's weights: the forward's chunk output, backward
      in time, with k in r's place, r in k's, do in v's and dS_{c+1} as the
      state.
    - dr, dk, dw and du in every chunk at once (``_chunk_grads``), from
      M = dO Vᵀ, H = dO S_cᵀ, G = V dS_{c+1}ᵀ and the pieces.  For t in
      sub-chunk I, with S the state at the start of I and dS the cotangent
      at its end, both sums over whole sub-chunks of pieces::

          dr_t = Y_t[t] + u k_t (do_t·v_t),    Y_t[i] = S_{t-1} do_i
          dk_t = e^{suf_t} (dS v_t) + Σ_{i∈I, i>t} r_i e^{P(t+1,i)} (do_i·v_t) + u r_t (do_t·v_t)
          dw_t = e^{suf_t} Σ_v dS ⊙ S_{t-1} + Σ_{i∈I, i>t} r_i e^{P(t+1,i)} Y_t[i]

      Y and Σ_v dS ⊙ S_{t-1} walk through I by the recurrence itself
      (``x <- w_t x + k_t (·)``); the sums over i in I are Horner's rule
      in w.  dw is the product of the two states, never ``d(log w) / w``:
      no step divides by a decay, so it holds for any w in [0, 1).
    """
    dt = _dtype(r, k, v, w, u, s0, dout, ds_final)
    B, T, H, K = r.shape
    NC = -(-T // CHUNK)
    rf, kf, vf, wf, df = (a.to(dt) for a in (r, k, v, w, dout))
    lw = torch.clamp(torch.log(wf), min=LW_FLOOR)
    uk = u.to(dt)[None]
    zero = torch.zeros(B, H, K, K, dtype=dt, device=r.device)
    rb, kb, vb, db, wb, lb = (_blocks(a, NC) for a in (rf, kf, vf, df, wf, lw))
    S, starts = zero if s0 is None else s0.to(dt), []
    for c in range(NC):
        starts.append(S)
        S = _chunk_state(kb[:, :, c], vb[:, :, c], lb[:, :, c], S)
    rr, kr, dr_, lr = (_blocks(_reversed_chunks(a), NC) for a in (rf, kf, df, lw))
    dS, ends = zero if ds_final is None else ds_final.to(dt), [None] * NC
    for c in range(NC - 1, -1, -1):
        ends[c] = dS
        dS = _chunk_state(rr[:, :, c], dr_[:, :, c], lr[:, :, c], dS)
    dv = torch.stack([_chunk_out(kr[:, :, c], rr[:, :, c], dr_[:, :, c], lr[:, :, c], uk, ends[c])
                      for c in range(NC)], dim=2)
    grads = [_chunk_grads(rb[:, :, c], kb[:, :, c], vb[:, :, c], db[:, :, c], wb[:, :, c],
                          lb[:, :, c], uk, starts[c], ends[c]) for c in range(NC)]
    dr, dk, dw = (_unblocks(torch.stack([g[x] for g in grads], dim=2), T) for x in range(3))
    du = torch.zeros(H, K, dtype=dt, device=r.device)
    for b in range(B):  # the partials in order: b, then c
        for g in grads:
            du = du + g[3][b]
    return dr, dk, _reversed_chunks(_unblocks(dv, T)), dw, du, (None if s0 is None else dS)
