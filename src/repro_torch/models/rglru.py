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
order of the f32 products.

Serving carries a state per row, ``{'conv': (B, cw-1, W), 'h': (B, W)}``
(``init_rglru_state``): the conv's trailing inputs, in ``param_dtype``,
and the recurrence's last h, f32.  The block reads it as the conv's left
context and the kernel's ``h0``, and writes the new state into the same
tensors in place, so a one-token decode step runs the kernel at T = 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rglru import rglru
from ..kernels.rglru.ref import rglru_scan_ref
from ..parallel.context import constrain
from ..parallel.sharding import is_dtensor, on_local_shards
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

    def forward(self, x: torch.Tensor, state: dict | None = None):
        """x (B, T, D), already normed by the caller -> (out (B, T, D), new
        state).  Without ``state`` (training) the conv starts from zeros, the
        recurrence from h0 = None, and the new state is None; with it, the
        state's tensors are read and then overwritten in place."""
        gate = constrain(F.gelu(x @ self.w_gate, approximate="tanh"), {0: "batch", 2: "model"})
        main = constrain(x @ self.w_main, {0: "batch", 2: "model"})
        conv_state = None if state is None else state["conv"]
        main, new_conv = causal_conv1d(main, self.conv_w, self.conv_b, conv_state)
        rec, new_h = rglru_scan(main, self, None if state is None else state["h"])
        out = constrain((rec * gate) @ self.w_out, {0: "batch"})
        if state is None:
            return out, None
        state["conv"].copy_(new_conv)
        state["h"].copy_(new_h)
        return out, state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv over time: x (B, T, W), w (cw, W), b (W,), from
    ``state`` (B, cw-1, W), the trailing inputs before x (zeros when None);
    the terms are summed in the JAX package's order.  Returns (out in x's
    dtype, the new state: the last cw-1 inputs)."""
    cw, T = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros(x.shape[0], cw - 1, x.shape[2])
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i : i + T] * w[i] for i in range(cw)) + b
    return out.to(x.dtype), xp[:, -(cw - 1):]


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
    h0 = None if h0 is None else h0.float()
    if not is_dtensor(a):
        h, hT = rglru(a, gated, h0)
    else:  # a DTensor (the dry run): the JAX model's associative scan, on each
        # rank's (batch, width) shard, differentiated by autograd
        h, hT = on_local_shards(rglru_scan_ref, a, (a, gated, h0),
                                ((0, 1, 2), (0, 1, 2), (0, 2)), ((0, 1, 2), (0, 2)))
    return h.to(x.dtype), hT


def init_rglru_state(cfg: ArchConfig, batch: int, device=None) -> dict:
    """A zero decode state for ``batch`` rows: ``conv`` (batch, cw-1, W) in
    ``param_dtype`` and ``h`` (batch, W) f32, as the JAX package's."""
    w = cfg.recurrent.lru_width or cfg.d_model
    cw = cfg.recurrent.conv_width
    return {
        "conv": torch.zeros(batch, cw - 1, w, dtype=cfg.param_dtype, device=device),
        "h": torch.zeros(batch, w, dtype=torch.float32, device=device),
    }
