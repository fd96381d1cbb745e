"""Mixture-of-experts FFN (counterpart of ``repro/models/moe.py``): top-k
routing with GShard-style grouped capacity dispatch [arXiv:2006.16668].

The block routes all T = B*S tokens as one GShard group (the JAX
``moe_block`` at its default ``moe_groups=1``) into expert buffers of
capacity ``C = _capacity(T)``, through a dispatch one-hot (1, T, E, C).
The JAX package sets more groups only per token shard under expert
parallelism, which the port does not have yet; ``route`` already takes
any leading group dimension.  The arithmetic is the JAX ``moe_block``'s,
step for step:

* the router in f32 (``x.float() @ router``), a softmax, the top-k
  choices (``torch.topk(..., sorted=True)``, as ``lax.top_k``), the gates
  renormalised by ``max(sum, 1e-9)``;
* each choice's slot in its expert's buffer from the cumsum over the
  group's ``T * k`` choices, flattened token-major then k, so earlier
  tokens win; a choice whose slot is ``>= C`` is dropped through the
  ``C + 1``-wide one-hot whose last column is cut;
* ``disp`` and ``combine`` in ``x``'s dtype, the dispatch and combine
  einsums, and the experts' SwiGLU as products batched over ``e``;
* the Switch/GShard load-balance aux ``E * sum(frac * mean_prob)``, where
  ``frac`` counts every choice, dropped ones too.

The JAX block's ``constrain(...)`` calls and its ``decode_ep`` branch only
place data on a mesh; on one device they change no arithmetic, and they are
not ported (expert parallelism comes with ``parallel/``).  The einsums are
plain matrix products, as in the JAX package, which runs them outside any
Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ArchConfig, MoE


def _capacity(tokens_per_group: int, moe: MoE) -> int:
    c = int(tokens_per_group * moe.top_k * moe.capacity_factor / moe.n_experts)
    return max(4, min(tokens_per_group, (c + 3) // 4 * 4))


def route(probs: torch.Tensor, moe: MoE, capacity: int):
    """Top-k routing of (G, tg, E) probabilities: (gate_vals, gate_idx,
    pos, keep), each (G, tg, k); ``pos`` is each choice's slot in its
    expert's buffer, ``keep`` whether it fits (``pos < capacity``)."""
    G, tg, E = probs.shape
    gate_vals, gate_idx = torch.topk(probs, moe.top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    onehot = F.one_hot(gate_idx, E)  # (G, tg, k, E) int64
    flat = onehot.reshape(G, tg * moe.top_k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, tg, moe.top_k, E)
    pos = torch.sum(pos * onehot, dim=-1)
    return gate_vals, gate_idx, pos, pos < capacity


class MoEBlock(nn.Module):
    """``{'router', 'w_gate', 'w_up', 'w_down'}`` in the JAX ``init_moe``
    shapes: an f32 (d, E) router, the experts' (E, d, f), (E, d, f) and
    (E, f, d) weights in ``param_dtype``.  ``forward(x)`` of (B, S, D)
    returns ``(out, aux)``: out (B, S, D) in x's dtype and the load-balance
    aux loss, an f32 scalar."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
        mk = lambda *shape, dtype=cfg.param_dtype: nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device))
        self.router = mk(d, e, dtype=torch.float32)
        self.w_gate, self.w_up, self.w_down = mk(e, d, f), mk(e, d, f), mk(e, f, d)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg, moe = self.cfg, self.cfg.moe
        B, S, D = x.shape
        T = B * S
        C = _capacity(T, moe)
        E = moe.n_experts

        xt = x.reshape(1, T, D)
        probs = torch.softmax(xt.float() @ self.router, dim=-1)  # (G, tg, E)
        gate_vals, gate_idx, pos, keep = route(probs, moe, C)
        disp = (F.one_hot(gate_idx, E).to(x.dtype)[..., None]
                * F.one_hot(torch.where(keep, pos, C), C + 1).to(x.dtype)[..., None, :-1])
        combine = torch.sum(disp * gate_vals[..., None, None].to(x.dtype), dim=2)
        disp = torch.sum(disp, dim=2)  # (G, tg, E, C)

        xe = torch.einsum("gtec,gtd->gecd", disp, xt)
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, self.w_gate))
        h = h * torch.einsum("gecd,edf->gecf", xe, self.w_up)
        ye = torch.einsum("gecf,efd->gecd", h, self.w_down)
        out = torch.einsum("gecd,gtec->gtd", ye, combine).reshape(B, S, D)

        frac = torch.mean(torch.sum(F.one_hot(gate_idx, E).float(), dim=2), dim=(0, 1))
        mean_prob = torch.mean(probs, dim=(0, 1))
        aux = E * torch.sum(frac * mean_prob)
        return out, aux
