"""Sharded TP decode: the ``ServePlan`` executed inside the engine step
(counterpart of ``repro/serving/sharded.py``).

``planning.serve`` prices the decode-side collectives (the fresh KV rows
every attention sublayer publishes across the tensor-parallel group, the
expert all-to-all of MoE archs) and merges them with the paper's Eq. 9/10
math.  This module is the executable counterpart: a decode step that runs
on every rank of a TP process group and issues **exactly one collective
per scheduled serve group** (``planning.serve.make_group_collective``),
the decode analogue of ``core.sync``'s one all-reduce per group.

Execution model: mirror-compute / sliced-wire
---------------------------------------------
Decode is latency-bound and sequentially dependent: stage ``i+1``'s input
is stage ``i``'s full output, so a collective whose result feeds the next
stage (the Megatron output-combine all-reduce) can never be deferred, let
alone merged across stages.  The collectives MG-WFBP *can* merge are the
ones whose results only future steps read: the KV-cache traffic
``ServePlan`` prices.  The rows written at step ``t`` are read again only
at step ``t+1``.

So the step runs **mirror-compute / sliced-wire** TP:

  * every rank computes the full decode locally (the current token's
    attention reads its fresh row locally: no blocking collective on the
    critical path);
  * rank ``r`` *owns* a ``ceil(F/N)``-wide slice (zero-padded) of every
    stage's ``F``-wide fresh KV row; the rows written back into the caches
    come **off the wire**: one all-gather per scheduled group, reassembled
    rank-major, so the cache rows really flow through the collectives;
  * MoE archs issue the plan's expert all-to-all per group instead (the
    dispatch traffic the plan priced); its outputs are the step's live
    outputs, and the locally written rows stand.

Numerics equal the unsharded engine's: the gathered slices are the same
values every rank computed, reassembled in rank order.

The JAX package wraps the step in ``shard_map`` (``sharded_decode_core``,
``sharded_decode_fn``).  The port has no ``shard_map``: every rank runs the
step on its own process group, and ``ServingEngine(mesh=...)`` calls
``make_sharded_decode_step``'s step directly (inside its one CUDA graph on
the card), so those two wrappers have no counterpart here.

``serving_param_pspecs`` / ``serving_cache_pspecs`` give the matching
at-rest layout as DTensor placements on the TP dimension (Megatron column
and row shards of the attention and MLP weights, head-dim shards of the KV
caches), and ``shard_serving_state`` places a state tree in it, to report
per-device memory.  ``ServeTimer`` (``serving.engine``) holds the step's
wall clock and the per-group measured comm samples.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..launch.steps import make_decode_step
from ..models.common import ArchConfig
from ..models.transformer import window_for
from ..planning.serve import make_group_collective
from .engine import ServeTimer

if TYPE_CHECKING:
    from ..planning.serve import ServePlan

__all__ = [
    "ServeTimer",
    "make_sharded_decode_step",
    "serving_cache_pspecs",
    "serving_param_pspecs",
    "shard_serving_state",
    "stack_fresh_rows",
    "write_fresh_rows",
]

#: Param-leaf names sharded on their LAST axis (Megatron column shards:
#: q/k/v projections and the MLP up/gate matrices) vs their second-to-last
#: axis (row shards: the output projections whose contraction dim is
#: sharded).
_COL_SHARD_KEYS = ("wq", "wk", "wv", "w_gate", "w_up")
_ROW_SHARD_KEYS = ("wo", "w_down")
_RECURRENT = ("rwkv", "rec")


def _write_index(cfg: ArchConfig, kind: str, cache_len: int, pos) -> torch.Tensor:
    """Ring index of this sublayer's cache row at ``pos`` (a (1,) long
    tensor): the rule the decode step writes by (``models.layers``),
    ``pos % T`` for a windowed sublayer, else ``pos`` clamped to the cache."""
    pos = torch.as_tensor(pos).reshape(1).long()
    return pos % cache_len if window_for(cfg, kind) else torch.clamp(pos, max=cache_len - 1)


def stack_fresh_rows(cfg: ArchConfig, caches: dict, pos) -> torch.Tensor | None:
    """The step's wire payload: ``(n_stages, F)`` fresh K/V rows.

    Reads the rows the decode step just wrote at ``pos`` out of every
    attention-bearing sublayer's stacked stage cache (K then V, pattern
    order) and flattens them per stage: the per-stage payload
    ``planning.serve.decode_unit_costs`` prices.  ``None`` for a
    recurrent-only arch (nothing on the serve wire)."""
    parts = []
    for i, kind in enumerate(cfg.pattern):
        if kind in _RECURRENT:
            continue
        k, v, _ = caches["stages"][f"{kind}_{i}"]
        idx = _write_index(cfg, kind, k.shape[2], pos).to(k.device)
        for arr in (k, v):
            parts.append(arr.index_select(2, idx).reshape(arr.shape[0], -1))
    if not parts:
        return None
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def write_fresh_rows(cfg: ArchConfig, caches: dict, stacked: torch.Tensor, pos) -> dict:
    """Inverse of ``stack_fresh_rows``: write ``(n_stages, F)`` rows back
    into the stage caches at ``pos``, in place (the caches are returned).

    On the sharded path ``stacked`` is the reassembled all-gather output,
    so the written rows come off the plan's collectives: the wire is
    load-bearing, not decorative."""
    off = 0
    for i, kind in enumerate(cfg.pattern):
        if kind in _RECURRENT:
            continue
        k, v, _ = caches["stages"][f"{kind}_{i}"]
        idx = _write_index(cfg, kind, k.shape[2], pos).to(k.device)
        for arr in (k, v):
            n_stages, b, _, h, hd = arr.shape
            width = b * h * hd
            row = stacked[:, off : off + width].reshape(n_stages, b, 1, h, hd)
            arr.index_copy_(2, idx, row.to(arr.dtype))
            off += width
    return caches


def make_sharded_decode_step(cfg: ArchConfig, plan: "ServePlan",
                             group: dist.ProcessGroup | None = None):
    """The plan-driven decode step of one rank of ``group`` (the default
    group when None): ``step(model, caches, batch, pos) -> (logits,
    caches, wire)``.

    It runs the ordinary decode (``launch.steps.make_decode_step``), cuts
    this rank's ``ceil(F/N)``-wide slice (zero-padded) out of the stacked
    fresh-row payload, and drives ``planning.serve.make_group_collective``:
    one collective per scheduled serve group.  Under the plan's
    ``all_gather`` the gathered rows are reassembled rank-major
    (``(N, g·w) -> (g, N·w)[:, :F]``) and written back into the caches
    (``wire`` is empty); under ``all_to_all`` (MoE) the exchanged buffers
    are returned as ``wire`` (valid until the next step) and the locally
    written rows stand.  A recurrent-only arch issues nothing."""
    base = make_decode_step(cfg)
    wire = make_group_collective(plan, group)
    groups = plan.schedule.groups
    is_gather = plan.op == "all_gather"
    n, r = dist.get_world_size(group), dist.get_rank(group)

    def step(model, caches: dict, batch: dict, pos):
        logits, caches = base(model, caches, batch, pos)
        stacked = stack_fresh_rows(cfg, caches, pos)
        if stacked is None:  # recurrent-only arch: nothing to cohere
            return logits, caches, ()
        full = stacked.shape[1]
        width = -(-full // n)  # ceil: every rank ships an equal slice
        pad = width * n - full
        padded = F.pad(stacked, (0, pad)) if pad else stacked
        outs = wire(padded[:, r * width : (r + 1) * width].contiguous())
        if not is_gather:
            return logits, caches, tuple(outs)
        rows = []
        for (lo, hi), out in zip(groups, outs):
            g = hi - lo + 1
            # (n, g·width) gather -> rank-major slices back to (g, n·width)
            rows.append(out.reshape(n, g, width).transpose(0, 1).reshape(g, n * width))
        write_fresh_rows(cfg, caches, torch.cat(rows, dim=0)[:, :full], pos)
        return logits, caches, ()

    return step


# ---------------------------------------------------------------------------
# At-rest layout (what a production engine holds its state in)
# ---------------------------------------------------------------------------


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nested dict / tuple tree; ``path`` holds
    the dict keys on the way (tuple positions add nothing, as a JAX
    sequence key has no name)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(_map_with_path(fn, v, path) for v in tree)
    return fn(path, tree)


def serving_param_pspecs(params: dict) -> dict:
    """Megatron at-rest placements, on the TP dimension, for the stacked
    parameter tree (``to_jax_params`` / ``param_shapes`` layout).

    q/k/v and MLP up/gate projections ``Shard`` their output (last) axis;
    the output projections (``wo`` / ``w_down``) their contraction axis
    (``ndim - 2``: stacked stage leaves keep the leading stage axis whole);
    everything else (norms, embed, head) is ``Replicate()``
    (``shard_serving_state`` puts ``Replicate()`` on the mesh's other
    dimensions)."""
    def spec_for(path, leaf):
        ndim = leaf.dim()
        if any(n in _COL_SHARD_KEYS for n in path) and ndim >= 2:
            return Shard(ndim - 1)
        if any(n in _ROW_SHARD_KEYS for n in path) and ndim >= 2:
            return Shard(ndim - 2)
        return Replicate()

    return _map_with_path(spec_for, params)


def serving_cache_pspecs(caches: dict) -> dict:
    """At-rest placements sharding every K/V cache leaf's head_dim (last)
    axis on the TP dimension: the decode-side memory win (the KV cache is
    the serving bottleneck); recurrent state and the ``kpos`` ring indices
    are ``Replicate()``."""
    def spec_for(path, leaf):
        if leaf.dim() >= 4 and leaf.is_floating_point():
            if any("_" in n and n.split("_")[0] not in _RECURRENT for n in path):
                return Shard(leaf.dim() - 1)
        return Replicate()

    return _map_with_path(spec_for, caches)


def shard_serving_state(params: dict, caches: dict, mesh: DeviceMesh, *,
                        tp_axis: str = "model") -> tuple[dict, dict]:
    """Place the stacked parameter tree and the cache tree in the at-rest
    TP layout as DTensors on ``mesh`` (``Replicate()`` on its other
    dimensions).  A leaf whose shard axis does not divide by the
    ``tp_axis`` size is replicated, as the reference places it (small
    reduced configs).  The mirror-compute step reads whole values, so this
    is for at-rest storage and memory reports, not the step's input.
    Every rank calls it in the same order (rank 0's values are sent)."""
    tp_dim = mesh.mesh_dim_names.index(tp_axis)
    size = mesh.size(tp_dim)

    def place(specs, tree):
        if isinstance(tree, dict):
            return {k: place(specs[k], tree[k]) for k in sorted(tree)}
        if isinstance(tree, tuple):
            return tuple(place(s, t) for s, t in zip(specs, tree))
        spec = specs
        if isinstance(spec, Shard) and tree.shape[spec.dim] % size:
            spec = Replicate()
        placements = [Replicate()] * mesh.ndim
        placements[tp_dim] = spec
        return distribute_tensor(tree, mesh, placements)

    return (place(serving_param_pspecs(params), params),
            place(serving_cache_pspecs(caches), caches))
