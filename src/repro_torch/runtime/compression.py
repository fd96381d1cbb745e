"""Gradient compression with error feedback (counterpart of
``repro/runtime/compression.py``).

Two wire formats:

* bf16 all-reduce: gradients cast to bf16 on the wire (2x vs f32);
  handled by ``core.sync.SyncConfig(compression='bf16')``.
  ``bf16_ef_encode`` is the error-feedback variant: the rounding error of
  the cast stays in a local f32 residual and is re-added next step, so
  the *expected* update is unbiased.  The arena wire path
  (``SyncConfig(fuse='arena', compression='bf16_ef')``) fuses exactly this
  encode into the ``kernels/comm_pack`` pack kernel: these functions give
  the same bits as its plain version, ``pack_arena_ref``.
* int8 RS+AG: ``compressed_psum_rs_ag`` reduce-scatters the f32 gradients
  (each rank owns a 1/N shard of the sum), quantizes its shard to int8
  with one f32 scale, all-gathers the int8 codes and the scales, and
  dequantizes.  The quantization error stays in a local error-feedback
  residual that is re-added next step [Karimireddy et al., 2019].

Wire bytes per element: RS 4B (N-1)/N + AG 1B (N-1)/N, about 5B, against
about 8B for an f32 all-reduce.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..fabric.model import Collective
from ..fabric.ops import issue

Tensors = dict[str, torch.Tensor]


@dataclasses.dataclass
class ErrorFeedbackState:
    """The error-feedback residual of each gradient."""

    residual: Tensors  # local quantization error, f32, per rank


def ef_init(grads_like: Tensors) -> ErrorFeedbackState:
    """A zero f32 residual for each tensor of ``grads_like``, on its device."""
    return ErrorFeedbackState(residual={
        n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for n, g in grads_like.items()
    })


def bf16_ef_encode(g: torch.Tensor, residual: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback bf16 wire encode: ``(wire, new_residual)``.

    ``wire = bf16(g + residual)`` and the new residual is what the cast
    dropped: the EF-SGD accumulate / quantize / carry step at f32 / bf16
    granularity."""
    acc = g.float() + residual.float()
    wire = acc.to(torch.bfloat16)
    return wire, acc - wire.float()


def bf16_ef_decode(wire: torch.Tensor, dtype: torch.dtype, scale: float = 1.0) -> torch.Tensor:
    """Inverse of the wire encode with the DP averaging scale fused."""
    return (wire.float() * scale).to(dtype)


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``x`` and its f32 scale, ``max(max|x|, 1e-30) / 127``;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    scale = torch.clamp(x.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_rs_ag(
    g: torch.Tensor,
    group: dist.ProcessGroup | None = None,
    residual: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-wire gradient sum over ``group`` (the default process group
    when None): ``(summed gradient, new residual)``, both f32 in ``g``'s
    shape.

    Three ``issue()`` calls: the reduce-scatter in f32 (sums must not
    saturate), then the all-gathers of the int8 codes and of the scales,
    where the (N-1)/N of the volume lives.  ``g`` is padded to a multiple
    of the world size.  The new residual is the quantizer's error on this
    rank's shard, at that shard's place, and zero elsewhere."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    gf = g.float()
    if residual is not None:
        gf = gf + residual
    flat = gf.reshape(-1)
    pad = (-flat.numel()) % world
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat.new_empty(flat.numel() // world)
    issue(Collective.REDUCE_SCATTER, flat, group, out=shard)
    q, scale = _quantize_int8(shard)
    q_all = q.new_empty(world * q.numel())
    issue(Collective.ALL_GATHER, q, group, out=q_all)
    s_all = scale.new_empty(world)
    issue(Collective.ALL_GATHER, scale.reshape(1), group, out=s_all)
    full = (q_all.reshape(world, -1).float() * s_all[:, None]).reshape(-1)[: gf.numel()]

    err = torch.zeros_like(flat).reshape(world, -1)
    err[rank] = shard - q.float() * scale
    return full.reshape(g.shape), err.reshape(-1)[: gf.numel()].reshape(g.shape)


def compressed_psum_rs_ag_ref(
    grads: list[torch.Tensor], residuals: list[torch.Tensor] | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Plain version of ``compressed_psum_rs_ag`` for every rank at once,
    in one process with no collective: rank ``i``'s inputs are
    ``grads[i]`` (and ``residuals[i]``), and its outputs come back at
    index ``i``.  Each shard's sum is taken in rank order."""
    world = len(grads)
    flats = []
    for i, g in enumerate(grads):
        gf = g.float() if residuals is None else g.float() + residuals[i]
        pad = (-gf.numel()) % world
        flats.append(torch.cat([gf.reshape(-1), gf.new_zeros(pad)]).reshape(world, -1))
    shards = []
    for i in range(world):
        s = flats[0][i]
        for f in flats[1:]:
            s = s + f[i]
        shards.append(s)
    coded = [_quantize_int8(s) for s in shards]
    size = grads[0].numel()
    full = torch.cat([q.float() * s for q, s in coded])[:size].reshape(grads[0].shape)
    new_res = []
    for i, (q, s) in enumerate(coded):
        err = torch.zeros_like(flats[i])
        err[i] = shards[i] - q.float() * s
        new_res.append(err.reshape(-1)[:size].reshape(grads[0].shape))
    return [full.clone() for _ in range(world)], new_res
