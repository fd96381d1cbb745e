"""Griffin / RecurrentGemma recurrent block: temporal conv + RG-LRU
[arXiv:2402.19427] (counterpart of ``repro/models/rglru.py``).

RG-LRU (real-gated linear recurrent unit), diagonal recurrence:

    r_t = σ(x_t W_a + b_a)            recurrence gate
    i_t = σ(x_t W_x + b_x)            input gate
    a_t = exp(-c · softplus(Λ) ⊙ r_t) with c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

The gates and decays are plain f32 PyTorch; the recurrence itself runs
through ``kernels.rglru.rglru`` (the ``rglru_fwd`` / ``rglru_bwd`` kernels
on the card, their plain versions on the CPU).  The JAX model computes the
same recurrence with ``jax.lax.associative_scan``; the two agree up to the
order of the f32 products.  Training path only: no decode state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rglru import rglru
from .common import ArchConfig

RGLRU_C = 8.0


def lam_init(width: int, device=None) -> torch.Tensor:
    """Λ so that a^(1/r) spans (0.9, 0.999), as in the paper (f32)."""
    lin = torch.linspace(0.9, 0.999, width, dtype=torch.float32, device=device)
    return torch.log(torch.expm1(-torch.log(lin) / RGLRU_C))


class RGLRUBlock(nn.Module):
    """``{'w_main', 'w_gate', 'conv_w', 'conv_b', 'wa', 'ba', 'wx', 'bx',
    'lam', 'w_out'}``, in ``param_dtype`` except ``ba``, ``bx`` and ``lam``,
    which are f32 as in the JAX package."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d = cfg.d_model
        w = cfg.recurrent.lru_width or d
        cw = cfg.recurrent.conv_width
        pd = cfg.param_dtype

        def mk(*shape, dtype=pd):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        self.w_main, self.w_gate = mk(d, w), mk(d, w)
        self.conv_w, self.conv_b = mk(cw, w), mk(w)
        self.wa, self.ba = mk(w, w), mk(w, dtype=torch.float32)
        self.wx, self.bx = mk(w, w), mk(w, dtype=torch.float32)
        self.lam = mk(w, dtype=torch.float32)
        self.w_out = mk(w, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, D), already normed by the caller -> (B, T, D)."""
        gate = F.gelu(x @ self.w_gate, approximate="tanh")
        main = causal_conv1d(x @ self.w_main, self.conv_w, self.conv_b)
        rec, _ = rglru_scan(main, self)
        return (rec * gate) @ self.w_out


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time: x (B, T, W), w (cw, W), b (W,), from a
    zero state; the terms are summed in the JAX package's order."""
    cw, T = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros(x.shape[0], cw - 1, x.shape[2]), x], dim=1)
    out = sum(xp[:, i : i + T] * w[i] for i in range(cw)) + b
    return out.to(x.dtype)


def rglru_scan(x: torch.Tensor, p: RGLRUBlock,
               h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over time, f32 inside: (h (B, T, W) in x's dtype, final
    state (B, W) f32).  ``h0`` goes to the kernel as its initial state (the
    JAX model folds it into the first step instead; the same function)."""
    xf = x.float()
    r = torch.sigmoid(xf @ p.wa.float() + p.ba)
    i = torch.sigmoid(xf @ p.wx.float() + p.bx)
    log_a = -RGLRU_C * F.softplus(p.lam) * r  # (B, T, W), <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * xf)
    h, hT = rglru(a, gated, None if h0 is None else h0.float())
    return h.to(x.dtype), hT
