"""Plain PyTorch versions of the RG-LRU recurrence kernels (counterparts of
``repro/kernels/rglru/ref.py`` and of the associative scan in
``repro/kernels/rglru/ops.py`` / ``repro/models/rglru.py``).

The recurrence is ``h_t = a_t * h_{t-1} + g_t`` over (B, T, W) from an
initial state ``h0`` (B, W) (zero when absent), returning ``h`` and the
final state ``hT = h_{T-1}``.  Everything is computed in f32 (in f64 for
f64 inputs, which the gradient checks use).

- ``rglru_ref``: the sequential loop, the kernel's plain version.
- ``rglru_scan_ref``: the same function in the order of
  ``jax.lax.associative_scan`` (odd/even recursion), the order the JAX
  model computes it in.
- ``rglru_bwd_ref``: the gradient, the reverse recurrence written out step
  by step: ``dg_{T-1} = dh_{T-1} + dhT``, ``dg_t = dh_t + a_{t+1} dg_{t+1}``,
  ``da_t = dg_t h_{t-1}`` (``h_{-1} = h0``), ``dh0 = a_0 dg_0``.
"""

from __future__ import annotations

import torch


def _dtype(*tensors: torch.Tensor | None) -> torch.dtype:
    dt = torch.float32
    for t in tensors:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return dt


def rglru_ref(a: torch.Tensor, g: torch.Tensor,
              h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential scan: h (B, T, W) and hT (B, W)."""
    dt = _dtype(a, g, h0)
    af, gf = a.to(dt), g.to(dt)
    B, T, W = a.shape
    h = torch.zeros(B, W, dtype=dt, device=a.device) if h0 is None else h0.to(dt)
    hs = []
    for t in range(T):
        h = af[:, t] * h + gf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _interleave(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x[0], y[0], x[1], y[1], ... along dim 1 (len(x) - len(y) in {0, 1})."""
    out = torch.empty((x.shape[0], x.shape[1] + y.shape[1], *x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    out[:, 0::2] = x
    out[:, 1::2] = y
    return out


def _associative_scan(elems):
    """Inclusive scan of (a, b) pairs along dim 1, in jax.lax.associative_scan's
    order: combine adjacent pairs, scan the odd positions recursively, then
    fill in the even ones."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine(tuple(e[:, 0:-1:2] for e in elems), tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine(tuple(e[:, :-1] for e in odd), tuple(e[:, 2::2] for e in elems))
    else:
        even = _combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, 0:1], r], dim=1) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def rglru_scan_ref(a: torch.Tensor, g: torch.Tensor,
                   h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence as an associative scan: h (B, T, W) and hT (B, W).
    ``h0`` is folded into the first step, ``g_0 += a_0 h0``, as the JAX model
    folds it."""
    dt = _dtype(a, g, h0)
    af, gf = a.to(dt), g.to(dt)
    if h0 is not None:
        gf = torch.cat([gf[:, :1] + af[:, :1] * h0.to(dt)[:, None], gf[:, 1:]], dim=1)
    _, h = _associative_scan((af, gf))
    return h, h[:, -1].clone()


def rglru_bwd_ref(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor | None,
                  dh: torch.Tensor, dhT: torch.Tensor | None = None):
    """Gradient of ``rglru_ref`` from the forward's ``h``: (da, dg, dh0), with
    dh0 None when ``h0`` is None."""
    dt = _dtype(a, h, h0, dh, dhT)
    af, hf, dhf = a.to(dt), h.to(dt), dh.to(dt)
    B, T, W = a.shape
    y = torch.zeros(B, W, dtype=dt, device=a.device) if dhT is None else dhT.to(dt)
    h_init = torch.zeros(B, W, dtype=dt, device=a.device) if h0 is None else h0.to(dt)
    da = torch.empty(B, T, W, dtype=dt, device=a.device)
    dg = torch.empty_like(da)
    for t in range(T - 1, -1, -1):
        y = dhf[:, t] + (af[:, t + 1] * y if t + 1 < T else y)
        dg[:, t] = y
        da[:, t] = y * (hf[:, t - 1] if t > 0 else h_init)
    dh0 = None if h0 is None else af[:, 0] * y
    return da, dg, dh0
