"""Optimizers: SGD(+momentum), the paper's optimizer, and AdamW
(counterpart of ``repro/optim/optimizers.py``).

Parameters, gradients and state are dicts of tensors keyed by parameter
name.  Updates are written **in place** (into the parameters and the
state), where the JAX package returns new trees; the arithmetic is the
same: state in f32, the update computed in f32 and cast to the
parameter's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass
class OptState:
    """Optimizer state: the step count and per-parameter f32 buffers."""

    step: int
    m: dict[str, torch.Tensor]  # momentum / first moment (empty for plain SGD)
    v: dict[str, torch.Tensor]  # second moment (AdamW only)


@torch.no_grad()
def clip_by_global_norm(grads: Tensors, max_norm: float) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """``(grads scaled to a global L2 norm of at most max_norm, the norm)``,
    as the JAX function computes them: the norm is the square root of the
    f32 sums of squares, the scale ``min(1, max_norm / max(norm, 1e-12))``
    is applied in f32 and each gradient is cast back to its dtype.  Returns
    new tensors; the norm is an f32 0-d tensor."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, gnorm


def _zeros(params: Tensors) -> dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}


# ---------------------------------------------------------------------------
# SGD + momentum (paper Eq. 1/2)
# ---------------------------------------------------------------------------


def sgd_init(params: Tensors, momentum: float = 0.0) -> OptState:
    """SGD state: an f32 momentum buffer per parameter when ``momentum``."""
    return OptState(step=0, m=_zeros(params) if momentum else {}, v={})


@torch.no_grad()
def sgd_update(
    grads: Tensors, state: OptState, params: Tensors, lr: float, momentum: float = 0.0
) -> OptState:
    """One SGD(+momentum) step, in place: ``m = momentum*m + g``,
    ``p = p - lr*m`` (``g`` without momentum), computed in f32."""
    for n, p in params.items():
        g = grads[n]
        if momentum:
            m = state.m[n]
            m.copy_(momentum * m + g.float())
            g = m
        p.copy_((p.float() - lr * g.float()).to(p.dtype))
    state.step += 1
    return state


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params: Tensors) -> OptState:
    """AdamW state: f32 first and second moments per parameter."""
    return OptState(step=0, m=_zeros(params), v=_zeros(params))


@torch.no_grad()
def adamw_update(
    grads: Tensors,
    state: OptState,
    params: Tensors,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> OptState:
    """One AdamW step, in place (bias-corrected moments, decoupled weight
    decay, the update computed in f32 and cast to the parameter dtype)."""
    state.step += 1
    t = torch.tensor(float(state.step), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
    for n, p in params.items():
        g = grads[n].float()
        m, v = state.m[n], state.v[n]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        step_val = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        p.copy_((p.float() - lr * step_val).to(p.dtype))
    return state


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optimizer as its init and in-place update functions."""

    init: Callable[[Tensors], OptState]
    update: Callable[..., OptState]  # (grads, state, params, lr) -> state
    name: str


def make_optimizer(name: str, **kw) -> Optimizer:
    """``'sgd'`` (``momentum=``) or ``'adamw'`` (``b1, b2, eps,
    weight_decay``) as an ``Optimizer``."""
    if name == "sgd":
        momentum = kw.get("momentum", 0.0)
        return Optimizer(
            init=lambda p: sgd_init(p, momentum),
            update=lambda g, s, p, lr: sgd_update(g, s, p, lr, momentum),
            name="sgd",
        )
    if name == "adamw":
        return Optimizer(
            init=adamw_init,
            update=lambda g, s, p, lr: adamw_update(g, s, p, lr, **kw),
            name="adamw",
        )
    raise ValueError(name)
