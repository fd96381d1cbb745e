"""Cost sources: where the scheduler's per-layer time vector comes from
(counterpart of ``repro/planning/costs.py``).

  * ``AnalyticCosts``  — the Eq. 18 / roofline estimate (flops and bytes
    per unit converted to seconds by a ``Hardware`` preset);
  * ``MeasuredCosts``  — wall-clock observations: per-unit times from the
    unit probes (``runtime/timeline.py``), or a whole-step timing that
    rescales the analytic compute model.  Measured times are expressed
    against ``MEASURED_HW`` (unit hardware: 1 flop == 1 second) so the
    scheduler math is unchanged.

``replan_if_drifted`` is the journal version's online re-planning: when a
live cost measurement drifts from the vector a plan was built with, the
same policy reruns on the measured vector and a successor plan is
emitted.

The *communication* side has the same analytic/measured split:
``MeasuredComm`` times real all-reduces over a size sweep on a
``torch.distributed`` process group and least-squares fits the (α, β) of
Eq. 9 (journal §V-A Fig. 5(b), online).  Its ``fit()`` is an ordinary
``AllReduceModel``, so plans and every registered policy consume measured
comm models transparently.  The timed all-reduces call
``dist.all_reduce`` directly, not ``fabric.ops.issue``: they are
measurements, and the seam counts only the training sync's collectives.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Protocol, runtime_checkable

import torch
import torch.distributed as dist

from ..core.bucketing import layer_buckets_for_scan
from ..core.comm_model import AllReduceModel, fit_affine
from ..core.cost_model import Hardware, LayerCost, TPU_V5E
from .plan import Plan
from .registry import build_schedule, resolve_policy_name

#: Unit hardware: costs carry wall-clock seconds directly in ``bwd_flops``
#: / ``fwd_flops`` (1 FLOP == 1 s, no memory term).
MEASURED_HW = Hardware(
    name="measured_wallclock", peak_flops=1.0, hbm_bw=1.0, mxu_eff=1.0, hbm_eff=1.0
)


@runtime_checkable
class CostSource(Protocol):
    """A producer of the scheduler's per-layer cost vector."""

    name: str
    hw: Hardware

    def layer_costs(self) -> list[LayerCost]: ...


@dataclasses.dataclass(frozen=True)
class AnalyticCosts:
    """Eq. 18-style analytic cost vector."""

    costs: tuple[LayerCost, ...]
    hw: Hardware = TPU_V5E
    name: str = "analytic"

    def layer_costs(self) -> list[LayerCost]:
        return list(self.costs)


@dataclasses.dataclass(frozen=True)
class MeasuredCosts:
    """Wall-clock per-unit cost vector (seconds, against ``MEASURED_HW``)."""

    costs: tuple[LayerCost, ...]
    hw: Hardware = MEASURED_HW
    name: str = "measured"

    def layer_costs(self) -> list[LayerCost]:
        return list(self.costs)

    @classmethod
    def from_unit_times(
        cls,
        base: list[LayerCost],
        bwd_seconds: list[float],
        fwd_seconds: list[float] | None = None,
        name: str = "measured",
    ) -> "MeasuredCosts":
        """Directly measured per-unit backward (and optional forward) times.

        Message sizes and param counts are carried over from ``base`` —
        measurement changes *times*, never payloads.
        """
        if len(bwd_seconds) != len(base):
            raise ValueError(f"{len(bwd_seconds)} times for {len(base)} units")
        if fwd_seconds is not None and len(fwd_seconds) != len(base):
            raise ValueError(f"{len(fwd_seconds)} fwd times for {len(base)} units")
        out = []
        for i, c in enumerate(base):
            out.append(
                LayerCost(
                    name=c.name,
                    params=c.params,
                    grad_bytes=c.grad_bytes,
                    bwd_flops=float(bwd_seconds[i]),
                    fwd_flops=float(fwd_seconds[i]) if fwd_seconds is not None else 0.0,
                )
            )
        return cls(costs=tuple(out), name=name)

    @classmethod
    def from_step_timing(
        cls,
        base: list[LayerCost],
        base_hw: Hardware,
        measured_t_iter: float,
        modeled_t_iter: float,
        name: str = "measured_step",
    ) -> "MeasuredCosts":
        """Whole-step wall-clock calibration (cheapest online signal).

        One measured iteration time rescales every analytic compute time by
        ``measured / modeled``; comm (α–β) stays fixed, so the
        compute/comm overlap balance — and hence the optimal merge set —
        genuinely shifts.
        """
        if modeled_t_iter <= 0 or measured_t_iter <= 0:
            raise ValueError("step times must be positive")
        scale = measured_t_iter / modeled_t_iter
        bwd = [c.t_b(base_hw) * scale for c in base]
        fwd = [c.t_f(base_hw) * scale for c in base]
        return cls.from_unit_times(base, bwd, fwd, name=name)

    @classmethod
    def from_segment_times(
        cls,
        base: list[LayerCost],
        base_hw: Hardware,
        unit_seconds: dict[str, float],
        name: str = "measured_segments",
    ) -> "MeasuredCosts":
        """Per-unit overrides from the unit probes.

        ``unit_seconds`` maps unit names (``embed``, ``stage_0``, ...,
        ``head``) to measured backward seconds; unmeasured units keep their
        analytic time.
        """
        bwd = [unit_seconds.get(c.name, c.t_b(base_hw)) for c in base]
        fwd = [c.t_f(base_hw) for c in base]
        return cls.from_unit_times(base, bwd, fwd, name=name)


#: A timed probe this many times slower than the running min is treated
#: as an outlier (GC pause, noisy neighbor) and re-taken rather than
#: recorded — see ``min_of_k``.
PROBE_OUTLIER_FACTOR = 10.0


def min_of_k(
    sample_fn: Callable[[], float],
    repeats: int,
    *,
    outlier_factor: float = PROBE_OUTLIER_FACTOR,
    max_retries: int | None = None,
) -> float:
    """Min of ``repeats`` samples with an outlier retry.

    A sample exceeding ``outlier_factor`` × the running min is discarded
    and re-taken.  Retries are bounded by ``max_retries`` (default
    ``repeats``) so a *genuine* sustained slowdown is reported, not spun
    on: once the budget is spent every sample counts.
    """
    repeats = max(1, repeats)
    budget = repeats if max_retries is None else max(0, max_retries)
    best = float("inf")
    taken = retried = 0
    while taken < repeats:
        t = float(sample_fn())
        if t > outlier_factor * best and retried < budget:
            retried += 1
            continue
        best = min(best, t)
        taken += 1
    return best


def rank0_values(values: list[float], group: dist.ProcessGroup | None = None,
                 device: torch.device | str = "cpu") -> list[float]:
    """The group's rank 0's ``values`` on every rank of ``group`` (the
    default process group when None): one plain ``dist.broadcast``, not
    through the counted ``issue()`` seam; the values themselves in a group
    of one.  Every rank then decides from the same measurements."""
    if dist.get_world_size(group) == 1:
        return [float(v) for v in values]
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.broadcast(t, src=0 if group is None else dist.get_global_rank(group, 0), group=group)
    return t.tolist()


def time_collective_call(
    f, x, repeats: int = 3, warmup: int = 1,
    clock: Callable[[], float] = time.perf_counter,
    agree: Callable[[float], float] | None = None,
) -> float:
    """Run ``warmup`` discarded calls (at least one: NCCL builds its
    communicator at the first collective, which must never reach a timed
    sample) and return the min of ``repeats`` timed calls through
    ``min_of_k``.  On a CUDA tensor the device is synchronized before
    each clock read.  ``clock`` is injectable (the FakeClock pattern) so
    tests never assert on real wall-clock deltas.

    ``min_of_k`` re-takes an outlier, so on several ranks each would make
    as many collective calls as its own samples ask for, and the ranks'
    calls would no longer match; ``agree`` maps each sample to one value
    every rank shares (``MeasuredComm.time_psums``: rank 0's), so all
    ranks retry alike."""
    on_cuda = isinstance(x, torch.Tensor) and x.device.type == "cuda"

    def call() -> None:
        f(x)
        if on_cuda:
            torch.cuda.synchronize(x.device)

    for _ in range(max(1, warmup)):
        call()

    def sample() -> float:
        t0 = clock()
        call()
        t = clock() - t0
        return t if agree is None else agree(t)

    return min_of_k(sample, repeats)


#: Default all-reduce size sweep: 4 KiB … 128 MiB in ×8 steps — small
#: enough to expose α, large enough to pin β.
DEFAULT_COMM_SWEEP = tuple(4 * 1024 * 8**i for i in range(6))

#: Amortized re-fit sweep: one small, one mid, one large size.
SLIM_COMM_SWEEP = (DEFAULT_COMM_SWEEP[0], DEFAULT_COMM_SWEEP[2], DEFAULT_COMM_SWEEP[5])


def _all_reduce_fn(group: dist.ProcessGroup | None):
    def f(v: torch.Tensor) -> None:
        dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)

    return f


@dataclasses.dataclass(frozen=True)
class MeasuredComm:
    """Measured (α, β) all-reduce model for one set of mesh axes.

    Raw observations are kept (sizes in bytes, wall seconds) so the fit
    is reproducible and re-fittable; ``fit()`` returns the affine
    ``AllReduceModel`` every policy/plan already consumes.
    """

    sizes_bytes: tuple[int, ...]
    times_s: tuple[float, ...]
    axes: tuple[str, ...] = ("data",)
    name: str = "measured_comm"

    def fit(self) -> AllReduceModel:
        return fit_affine(
            self.sizes_bytes, self.times_s,
            name=f"{self.name}[{'+'.join(self.axes)}]",
        )

    def update(
        self,
        sizes_bytes: tuple[int, ...] | list[int],
        times_s: tuple[float, ...] | list[float],
        weight: float = 0.5,
    ) -> "MeasuredComm":
        """Fold fresh observations into the sweep (returns a new record).

        Re-observed sizes are exponentially weighted (``new = (1-w)·old +
        w·fresh``) so a transient spike does not whiplash the (α, β) fit,
        while sustained congestion converges in a few checks; unseen sizes
        are appended.
        """
        if not 0.0 < weight <= 1.0:
            raise ValueError(f"EWMA weight must be in (0, 1], got {weight}")
        obs = dict(zip(self.sizes_bytes, self.times_s))
        for s, t in zip(sizes_bytes, times_s):
            s = int(s)
            obs[s] = (1.0 - weight) * obs[s] + weight * float(t) if s in obs else float(t)
        items = sorted(obs.items())
        return dataclasses.replace(
            self,
            sizes_bytes=tuple(s for s, _ in items),
            times_s=tuple(t for _, t in items),
        )

    @classmethod
    def time_psums(
        cls,
        group: dist.ProcessGroup | None = None,
        axes: tuple[str, ...] = ("data",),
        sizes_bytes: tuple[int, ...] = DEFAULT_COMM_SWEEP,
        dtype: torch.dtype = torch.float32,
        repeats: int = 3,
        name: str = "measured_comm",
        device: torch.device | str = "cpu",
    ) -> "MeasuredComm":
        """Time real all-reduces over a size sweep on ``group`` (the
        default process group when None), one buffer per size on
        ``device``; the first call is discarded and the min of
        ``repeats`` timed calls is kept.  Every sample is rank 0's on every
        rank, so the ranks make the same calls and hold the same fit."""
        f = _all_reduce_fn(group)
        itemsize = torch.empty((), dtype=dtype).element_size()

        def agree(t: float) -> float:
            return rank0_values([t], group, device)[0]

        times = []
        for nb in sizes_bytes:
            x = torch.ones(max(1, int(nb) // itemsize), dtype=dtype, device=device)
            times.append(time_collective_call(f, x, repeats, agree=agree))
        return cls(
            sizes_bytes=tuple(int(s) for s in sizes_bytes),
            times_s=tuple(times), axes=tuple(axes), name=name,
        )


def measure_comm_models(
    groups: dict[str, dist.ProcessGroup | None] | None = None, **kwargs
) -> dict[str, AllReduceModel]:
    """Per-axis measured (α, β) fits — one ``MeasuredComm`` sweep and fit
    per axis name → process group (default ``{'data': None}``, the world),
    plus every axis jointly over the world group under the ``'+'``-joined
    key when there are several (the axes of a data-parallel mesh together
    span the world)."""
    groups = {"data": None} if groups is None else dict(groups)
    out = {
        ax: MeasuredComm.time_psums(g, (ax,), **kwargs).fit() for ax, g in groups.items()
    }
    if len(groups) > 1:
        axes = tuple(groups)
        out["+".join(axes)] = MeasuredComm.time_psums(None, axes, **kwargs).fit()
    return out


def cost_drift(plan: Plan, measured: CostSource) -> float:
    """Max relative per-unit backward-time deviation of measured vs plan.

    0.0 == identical; 0.5 == some layer's measured backward time is 50%
    away from what the plan was scheduled with.
    """
    base = [c.t_b(plan.hw) for c in plan.costs]
    new = [c.t_b(measured.hw) for c in measured.layer_costs()]
    if len(base) != len(new):
        raise ValueError(f"measured {len(new)} units, plan has {len(base)}")
    worst = 0.0
    for b, n in zip(base, new):
        denom = max(abs(b), 1e-12)
        worst = max(worst, abs(n - b) / denom)
    return worst


def replan_if_drifted(
    plan: Plan,
    measured: CostSource,
    threshold: float = 0.15,
    policy: str | None = None,
) -> tuple[Plan, bool]:
    """Re-run the plan's policy on measured costs when drift exceeds
    ``threshold``; returns ``(plan, replanned)``.

    The successor plan keeps the layout and α–β model, swaps in the
    measured cost vector and its hardware basis, and records the drift and
    cost source in provenance.  Below threshold the original plan is
    returned untouched — a re-plan rebuilds the train step, so it must be
    rare and deliberate.
    """
    drift = cost_drift(plan, measured)
    if drift <= threshold:
        return plan, False
    policy = resolve_policy_name(policy or plan.policy)
    costs = measured.layer_costs()
    schedule = build_schedule(
        policy, costs, plan.ar_model, hw=measured.hw, **plan.policy_opts
    )
    segments = (
        layer_buckets_for_scan(schedule, plan.n_scan_stages)
        if plan.n_scan_stages is not None
        else None
    )
    prov = dict(plan.provenance)
    prov.update(
        {
            "policy": policy,
            "cost_source": measured.name,
            "replanned_from": plan.provenance.get("cost_source", "?"),
            "drift": f"{drift:.4f}",
        }
    )
    new_plan = dataclasses.replace(
        plan,
        costs=tuple(costs),
        hw=measured.hw,
        schedule=schedule,
        segments=segments,
        provenance=prov,
    )
    return new_plan, True


def comm_drift(old: AllReduceModel, new: AllReduceModel) -> float:
    """Max relative deviation of the fitted (α, β) pair vs a reference.

    0.0 == identical constants; 9.0 == one of α/β moved ×10.
    Denominators are floored so a near-zero reference constant does not
    turn measurement noise into infinite drift.
    """
    da = abs(new.a - old.a) / max(abs(old.a), 1e-9)
    db = abs(new.b - old.b) / max(abs(old.b), 1e-15)
    return max(da, db)


def replan_if_comm_drifted(
    plan: Plan,
    new_model: AllReduceModel,
    threshold: float = 0.25,
    policy: str | None = None,
) -> tuple[Plan, bool]:
    """The comm-side analogue of ``replan_if_drifted``: re-run the plan's
    policy under a freshly fitted (α, β) model when it drifts past
    ``threshold``; returns ``(plan, replanned)``.

    The successor plan keeps the cost vector and layout, swaps in the
    measured all-reduce model, and records the drift in provenance.
    """
    drift = comm_drift(plan.ar_model, new_model)
    if drift <= threshold:
        return plan, False
    policy = resolve_policy_name(policy or plan.policy)
    costs = list(plan.costs)
    schedule = build_schedule(policy, costs, new_model, hw=plan.hw, **plan.policy_opts)
    segments = (
        layer_buckets_for_scan(schedule, plan.n_scan_stages)
        if plan.n_scan_stages is not None
        else None
    )
    prov = dict(plan.provenance)
    prov.update(
        {
            "policy": policy,
            "comm_source": new_model.name,
            "replanned_from_comm": plan.ar_model.name,
            "comm_drift": f"{drift:.4f}",
        }
    )
    new_plan = dataclasses.replace(
        plan,
        ar_model=new_model,
        schedule=schedule,
        segments=segments,
        provenance=prov,
    )
    return new_plan, True
