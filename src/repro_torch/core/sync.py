"""Gradient synchronization engine (counterpart of ``repro/core/sync.py``).

One bucketed reducer, ``make_gradient_sync``, driven by a ``ParamLayout``
and the schedule a policy produced: exactly one all-reduce per schedule
group, issued through ``fabric.ops.issue`` (which counts its calls).

Gradients are named tensors (``{parameter name: grad}``, the names of
``models.transformer``) and are reduced **in place**; so is the
error-feedback residual (``{name: f32 tensor}``, per-rank state with no
DP axis).  Wire layouts:

  ``concat`` — each group's leaves cast to the wire dtype and
               concatenated into one buffer, one all-reduce, split and
               cast back, divided by the world size.
  ``arena``  — the group is packed into a flat arena by the
               ``kernels/comm_pack`` pack kernel (wire cast and optional
               error feedback fused), reduced with one all-reduce, and
               unpacked (decompress and ``1/world`` scale fused) straight
               into the gradient tensors.

  ``variadic`` — each group's leaves cast to the wire dtype (a view when
               they have it already) and summed in **one coalesced
               all-reduce** over the list (the JAX tuple ``psum``), which
               counts as one ``issue()``; no arena and no concatenation,
               then cast back and divided by the world size.  A coalesced
               call runs on gloo and NCCL (``dist._coalescing_manager``,
               the other way to batch collectives, does not run on gloo).

A group's reduction is split in two, so that a caller that knows when
the group's last gradient lands can start it then and finish it later:
``start_group`` packs and issues the all-reduce (asynchronously when
asked), ``finish_group`` waits and unpacks.

Given a ``core.profiler.TraceRecorder``, ``start_group`` brackets the
group's all-reduce in a ``wfbp_group{gi}_l{lo}_{hi}`` span carrying the
group's wire bytes: it begins once the arena is packed and ends when the
collective completes (on the profiler's clock: when ``issue()`` returns).
A recorder on the profiler's clock also gets the group's phases: a
``sync.pack`` span over the pack / cast / concat before ``issue()`` (args
``group``, ``leaves`` and ``bytes``, the group's wire bytes
``group_wire_bytes[gi]``), and in ``finish_group`` a ``sync.wait`` span
over the work's ``wait()`` and a ``sync.unpack`` span over the unpack or
copy back (args ``group``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.distributed as dist

from ..fabric.model import Collective
from ..fabric.ops import issue
from ..kernels.comm_pack import pack_arena, unpack_arena
from .bucketing import ParamLayout, bucket_assignment, entry_param_names, wire_entries
from .schedule import Schedule

__all__ = [
    "GradientSync",
    "SyncConfig",
    "count_expected_allreduces",
    "make_gradient_sync",
    "wire_entries",
]

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """How DP gradients are reduced.

    comm_dtype  : dtype gradients are cast to on the wire.
    average     : divide by the DP world size after summing.
    compression : None | 'bf16' | 'bf16_ef' (arena only).
    fuse        : 'concat' | 'variadic' | 'arena'.
    """

    comm_dtype: torch.dtype = torch.float32
    average: bool = True
    compression: str | None = None
    fuse: str = "concat"

    @property
    def wire_dtype(self) -> torch.dtype:
        if self.compression in ("bf16", "bf16_ef"):
            return torch.bfloat16
        return self.comm_dtype


@dataclasses.dataclass
class PendingGroup:
    """One group whose all-reduce has been issued but not unpacked."""

    gi: int
    buffer: torch.Tensor | list[torch.Tensor]  # the arena / concat buffer or the
    # variadic list of wire tensors, reduced in place
    work: object | None  # async work handle, None when issued blocking
    grads: list[torch.Tensor]


class GradientSync:
    """The reducer ``make_gradient_sync`` builds (see module docstring)."""

    def __init__(
        self,
        layout: ParamLayout,
        schedule: Schedule,
        config: SyncConfig = SyncConfig(),
        group: dist.ProcessGroup | None = None,
    ):
        if config.fuse not in ("concat", "variadic", "arena"):
            raise ValueError(f"unknown fuse mode {config.fuse!r}")
        if config.compression not in (None, "bf16", "bf16_ef"):
            raise ValueError(f"unknown compression {config.compression!r}")
        if config.compression == "bf16_ef" and config.fuse != "arena":
            raise ValueError("error-feedback compression requires fuse='arena'")
        self.config = config
        self.group = group
        self.schedule = schedule
        self.group_entries = wire_entries(layout, schedule)
        #: parameter names of each group in wire order (backward issue order)
        self.group_names = [
            [n for e in entries for n in entry_param_names(e)] for entries in self.group_entries
        ]
        self.stateful = config.compression == "bf16_ef"
        self.n_groups = len(self.group_entries)
        #: (lo, hi) layer spans in backward issue order
        self.group_spans = tuple(reversed(schedule.groups))
        #: per-group wire payload: the layout's per-unit bytes (wire dtype
        #: included), the "p" vector the schedule was optimized over
        self.group_wire_bytes = tuple(
            sum(u.grad_bytes for u in units)
            for units in reversed(bucket_assignment(layout, schedule))
        )
        #: the trace span name of each group
        self.span_names = tuple(f"wfbp_group{gi}_l{lo}_{hi}"
                                for gi, (lo, hi) in enumerate(self.group_spans))

    def world(self) -> int:
        return dist.get_world_size(self.group)

    def start_group(
        self, gi: int, grads: Tensors, residual: Tensors | None = None, *,
        async_op: bool = False, recorder=None,
    ) -> PendingGroup:
        """Pack group ``gi`` (backward issue order) and issue its one
        all-reduce.  Under ``bf16_ef`` the residual is updated here.  With
        a ``recorder`` the all-reduce is recorded as the group's span."""
        if self.stateful and residual is None:
            raise ValueError("compression='bf16_ef' needs the residual")
        names = self.group_names[gi]
        if recorder is not None:
            dev = dist.get_rank(self.group)
            recorder.phase_begin("sync.pack", device=dev, nbytes=self.group_wire_bytes[gi],
                                 group=gi, leaves=len(names))
        parts = [grads[n] for n in names]
        wire = self.config.wire_dtype
        if self.config.fuse == "arena":
            offsets = _offsets(parts)
            buf = pack_arena(
                parts, offsets, sum(p.numel() for p in parts), wire,
                residuals=[residual[n] for n in names] if self.stateful else None,
            )
        elif self.config.fuse == "variadic":
            buf = [p.to(wire) for p in parts]
        else:
            buf = torch.cat([p.reshape(-1).to(wire) for p in parts])
        if recorder is not None:
            recorder.phase_end("sync.pack", device=dev)
            recorder.span_begin(self.span_names[gi], device=dev,
                                nbytes=self.group_wire_bytes[gi])
        work = issue(Collective.ALL_REDUCE, buf, self.group, async_op=async_op)
        if recorder is not None:
            recorder.span_end(self.span_names[gi], device=dev, work=work)
        return PendingGroup(gi=gi, buffer=buf, work=work, grads=parts)

    def finish_group(self, pending: PendingGroup, *, recorder=None) -> None:
        """Wait for the group's all-reduce and write the reduced, averaged
        values back into its gradient tensors.  With a ``recorder`` on the
        profiler's clock the wait and the unpack are its spans."""
        if recorder is not None:
            dev = dist.get_rank(self.group)
            recorder.phase_begin("sync.wait", device=dev, group=pending.gi)
        if pending.work is not None:
            pending.work.wait()
        if recorder is not None:
            recorder.phase_end("sync.wait", device=dev)
            recorder.phase_begin("sync.unpack", device=dev, group=pending.gi)
        self._unpack(pending)
        if recorder is not None:
            recorder.phase_end("sync.unpack", device=dev)

    def _unpack(self, pending: PendingGroup) -> None:
        parts, red = pending.grads, pending.buffer
        world = float(self.world())
        if self.config.fuse == "arena":
            scale = (1.0 / world) if self.config.average else 1.0
            unpack_arena(red, _offsets(parts), parts, scale)
            return
        if self.config.fuse == "variadic":
            reduced = red
        else:
            reduced, off = [], 0
            for p in parts:
                reduced.append(red[off : off + p.numel()].view(p.shape))
                off += p.numel()
        for p, r in zip(parts, reduced):
            r = r.to(p.dtype)
            if self.config.average:
                r = (r.float() / world).to(p.dtype)
            p.copy_(r)

    def sync_group(self, gi: int, grads: Tensors, residual: Tensors | None = None, *,
                   recorder=None) -> None:
        """Reduce group ``gi`` alone, blocking."""
        self.finish_group(self.start_group(gi, grads, residual, recorder=recorder),
                          recorder=recorder)

    def __call__(self, grads: Tensors, residual: Tensors | None = None) -> None:
        """Reduce every group, in backward issue order."""
        for gi in range(self.n_groups):
            self.sync_group(gi, grads, residual)


def _offsets(parts: list[torch.Tensor]) -> list[int]:
    out, off = [], 0
    for p in parts:
        out.append(off)
        off += p.numel()
    return out


def make_gradient_sync(
    layout: ParamLayout,
    schedule: Schedule,
    config: SyncConfig = SyncConfig(),
    group: dist.ProcessGroup | None = None,
) -> GradientSync:
    """Build the reducer for ``schedule`` over ``group`` (the default
    process group when None)."""
    return GradientSync(layout, schedule, config, group)


def count_expected_allreduces(schedule: Schedule, config: SyncConfig = SyncConfig()) -> int:
    """Gradient all-reduces one sync issues: one per schedule group for
    every layout (``variadic``'s is one coalesced call)."""
    if config.fuse not in ("concat", "variadic", "arena"):
        raise ValueError(f"unknown fuse mode {config.fuse!r}")
    return len(schedule.groups)
