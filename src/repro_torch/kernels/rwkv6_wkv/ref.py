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
