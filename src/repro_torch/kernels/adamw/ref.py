"""The plain PyTorch version of the AdamW step: the port's update as it ran
before the kernel, leaf by leaf, moved here unchanged.

It is the arithmetic the CUDA kernel in ``csrc/adamw.cu`` must reproduce bit
for bit: every operation below is one PyTorch kernel that rounds its f32
result once, with the Python scalars rounded to f32 as PyTorch rounds them.
It runs for CPU and ``meta`` tensors (and DTensors over them): the CPU tests,
the JAX parity tests and the dry run's counts take it.
"""

from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def adamw_step_ref(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    ms: Sequence[torch.Tensor],  # f32 first moments, one per parameter
    vs: Sequence[torch.Tensor],  # f32 second moments
    lr: float,
    b1: float,
    b2: float,
    eps: float,
    weight_decay: float,
    bc1: float,  # 1 - b1**t, as the caller computed it
    bc2: float,  # 1 - b2**t
) -> None:
    """One AdamW step over the leaves, in place (bias-corrected moments,
    decoupled weight decay, the update computed in f32 and cast to the
    parameter dtype)."""
    for p, g, m, v in zip(params, grads, ms, vs):
        g = g.float()
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        step_val = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        p.copy_((p.float() - lr * step_val).to(p.dtype))
