"""Closed-loop auto-tuner: registry-wide plan search over measured costs
(counterpart of ``repro/planning/tuner.py``).

MG-WFBP's optimality claim (arXiv:1811.11141 §IV, journal arXiv:1912.09268)
rests on feeding the merge solver *measured* per-layer backward times and a
*measured* (α, β) comm model, re-derived as conditions change:

  * ``Tuner.sweep`` runs EVERY registered policy against the current cost
    vector and (α, β) model, scores each candidate by its predicted
    ``t_iter`` (tie-broken toward fewer groups, then policy name — fully
    deterministic), optionally scores arena wire bytes per candidate from
    ``bucketing.group_arenas``, and returns the argmin ``Plan`` with a
    provenance record naming the policy, the cost/comm sources, and the
    predicted ``t_iter``;
  * ``Tuner.observe`` writes the measured iteration time back into the
    latest sweep record, so every plan carries predicted-vs-observed;
  * ``CommRefitter`` is the amortized comm-side drift monitor: a few timed
    all-reduces per check (``SLIM_COMM_SWEEP``), exponentially weighted
    into the stored sweep (``MeasuredComm.update``), refit via
    ``core.comm_model.fit_affine``, re-plan when ``comm_drift`` crosses the
    threshold — the wire-side analogue of ``replan_if_drifted``;
  * tuner state (sweep history + comm observations) serializes to JSON
    (``state_dict`` / ``load_state``).

The launcher wires this in behind ``launch/train.py --autotune`` (per-unit
probes from ``runtime/timeline.py`` feed ``MeasuredCosts.from_segment_times``)
and ``--comm-refit-every``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..core.bucketing import ParamLayout, group_arenas, layer_buckets_for_scan
from ..core.comm_model import AllReduceModel
from ..core.cost_model import Hardware, LayerCost
from .costs import (
    SLIM_COMM_SWEEP,
    MeasuredComm,
    comm_drift,
    rank0_values,
    replan_if_comm_drifted,
)
from .plan import Plan, build_plan
from .registry import available_policies, resolve_policy_name

TUNER_FORMAT = 1

#: Exhaustive 2^(L-1) enumeration is only admissible for small unit counts.
MAX_EXHAUSTIVE_LAYERS = 14


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One scored (policy, plan) cell of a tuner sweep."""

    policy: str
    n_groups: int
    predicted_t_iter: float
    t_comm_exposed: float
    arena_bytes: int | None = None  # total wire-buffer bytes (when scored)

    def to_json_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SweepRecord:
    """Provenance of one registry-wide sweep (predicted vs observed)."""

    trigger: str  # 'startup' | 'restart' | 'cost_drift' | 'comm_drift' | 'sweep'
    chosen: str
    predicted_t_iter: float
    cost_source: str
    comm_source: str
    candidates: list[Candidate]
    observed_t_iter: float | None = None

    def to_json_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["candidates"] = [c.to_json_dict() for c in self.candidates]
        return d

    @classmethod
    def from_json_dict(cls, d: dict[str, Any]) -> "SweepRecord":
        d = dict(d)
        d["candidates"] = [Candidate(**c) for c in d["candidates"]]
        return cls(**d)


def default_policies(num_layers: int) -> tuple[str, ...]:
    """Every registered policy the sweep can afford, sorted (deterministic).

    ``optimal`` (exhaustive 2^(L-1)) is only included when the layer count
    makes it cheap; it then serves as the in-sweep ground truth.
    """
    names = set(available_policies())
    if num_layers > MAX_EXHAUSTIVE_LAYERS:
        names.discard("optimal")
    return tuple(sorted(names))


@dataclasses.dataclass
class Tuner:
    """Registry-wide argmin-``t_iter`` plan search over one layout.

    Attributes:
      layout:        communication units the plans are built over.
      n_scan_stages: scan segmentation input (None for flat layouts).
      policies:      policy names to sweep (default: every registered
                     policy, minus ``optimal`` for large L), sorted.
      policy_opts:   per-policy extra options (e.g. ``{'fixed':
                     {'bucket_bytes': ...}}``).
      shapes:        parameter (shape) pytree for arena-byte scoring via
                     ``bucketing.group_arenas`` (None skips that column).
      wire_dtype:    dtype name the arena bytes are scored at.
      history:       one ``SweepRecord`` per sweep, newest last.
    """

    layout: ParamLayout
    n_scan_stages: int | None = None
    policies: tuple[str, ...] | None = None
    policy_opts: dict[str, dict[str, Any]] = dataclasses.field(default_factory=dict)
    shapes: Any = None
    wire_dtype: str = "float32"
    provenance: dict[str, str] = dataclasses.field(default_factory=dict)
    history: list[SweepRecord] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if self.policies is None:
            self.policies = default_policies(self.layout.num_layers)
        else:
            self.policies = tuple(
                sorted(resolve_policy_name(p) for p in self.policies)
            )

    def sweep(
        self,
        costs: list[LayerCost],
        ar_model: AllReduceModel,
        hw: Hardware,
        *,
        cost_source: str = "analytic",
        comm_source: str = "analytic",
        trigger: str = "sweep",
        mode: str = "overlap",
    ) -> Plan:
        """Run every policy, return the argmin predicted-``t_iter`` Plan.

        Candidate order and the argmin are deterministic: policies are
        swept in sorted-name order and ties break by (t_iter, n_groups,
        policy name).  The chosen plan's provenance records the trigger,
        the predicted t_iter, and how many candidates it beat; the full
        per-candidate table lands in ``self.history``.

        ``mode`` prices every candidate under an issue-order model
        (``core.timeline.MODES``): ``overlap`` (DAG step, comm hides
        behind backward — the default) or ``serialized`` (post-backward
        step).  Non-default modes ride each candidate's ``policy_opts``
        so the plan artifact records what it was optimized for.
        """
        candidates: list[tuple[tuple, Candidate, Plan]] = []
        for policy in self.policies:
            opts = dict(self.policy_opts.get(policy) or {})
            if mode != "overlap":
                opts["mode"] = mode
            plan = build_plan(
                self.layout,
                list(costs),
                ar_model,
                policy=policy,
                hw=hw,
                n_scan_stages=self.n_scan_stages,
                cost_source=cost_source,
                policy_opts=opts or None,
                provenance=dict(self.provenance),
            )
            r = plan.schedule.result
            arena_bytes = None
            if self.shapes is not None:
                arena_bytes = sum(
                    a.nbytes
                    for a in group_arenas(
                        self.layout, plan.schedule, self.shapes, self.wire_dtype
                    )
                )
            cand = Candidate(
                policy=policy,
                n_groups=len(plan.schedule.groups),
                predicted_t_iter=r.t_iter,
                t_comm_exposed=r.t_comm_exposed,
                arena_bytes=arena_bytes,
            )
            candidates.append(((r.t_iter, len(plan.schedule.groups), policy), cand, plan))

        candidates.sort(key=lambda t: t[0])
        _, best, best_plan = candidates[0]
        record = SweepRecord(
            trigger=trigger,
            chosen=best.policy,
            predicted_t_iter=best.predicted_t_iter,
            cost_source=cost_source,
            comm_source=comm_source,
            candidates=[c for _, c, _ in candidates],
        )
        self.history.append(record)
        prov = dict(best_plan.provenance)
        prov.update(
            {
                "tuner": trigger,
                "comm_source": comm_source,
                "predicted_t_iter": f"{best.predicted_t_iter:.6e}",
                "candidates": str(len(candidates)),
            }
        )
        return dataclasses.replace(best_plan, provenance=prov)

    def sweep_fabric(
        self,
        costs: list[LayerCost],
        fabric: Any,
        axis_sizes: dict[str, int],
        hw: Hardware,
        *,
        op: str = "all_reduce",
        cost_source: str = "analytic",
        trigger: str = "sweep",
    ) -> Plan:
        """``sweep`` with the (α, β) model priced by a registry fabric.

        ``fabric`` is a preset name or live ``Fabric`` instance
        (``fabric.get_fabric``); the fabric's name lands in the record's
        ``comm_source`` so sweeps across backends stay attributable.
        """
        from ..fabric import get_fabric

        fab = get_fabric(fabric)
        return self.sweep(
            costs,
            fab.cost(op, axis_sizes),
            hw,
            cost_source=cost_source,
            comm_source=fab.name,
            trigger=trigger,
        )

    def observe(self, observed_t_iter: float) -> SweepRecord:
        """Record the measured iteration time against the latest sweep —
        the predicted-vs-observed pair every provenance story needs."""
        if not self.history:
            raise ValueError("observe() before any sweep()")
        self.history[-1].observed_t_iter = float(observed_t_iter)
        return self.history[-1]

    @property
    def last_record(self) -> SweepRecord | None:
        return self.history[-1] if self.history else None

    # -- serialization (rides beside checkpoints) ---------------------------

    def state_dict(self) -> dict[str, Any]:
        """JSON-serializable tuner state: sweep history + settings.  The
        layout/shapes are NOT serialized (the plan artifact already carries
        the layout); restoring state onto a freshly built Tuner resumes
        the predicted-vs-observed history across restarts."""
        return {
            "format": TUNER_FORMAT,
            "policies": list(self.policies),
            "policy_opts": {k: dict(v) for k, v in self.policy_opts.items()},
            "wire_dtype": self.wire_dtype,
            "history": [r.to_json_dict() for r in self.history],
        }

    def load_state(self, d: dict[str, Any]) -> "Tuner":
        """Restore serialized state in place (returns self)."""
        if d.get("format") != TUNER_FORMAT:
            raise ValueError(f"unsupported tuner state format {d.get('format')!r}")
        self.policies = tuple(d["policies"])
        self.policy_opts = {k: dict(v) for k, v in d.get("policy_opts", {}).items()}
        self.wire_dtype = d.get("wire_dtype", "float32")
        self.history = [SweepRecord.from_json_dict(r) for r in d["history"]]
        return self


@dataclasses.dataclass
class CommRefitter:
    """Amortized online (α, β) drift monitor (journal Fig. 5(b), live).

    Holds the full startup ``MeasuredComm`` sweep; each ``check`` times
    only ``probe_sizes`` (a few psums), exponentially weights them into
    the stored observations, refits, and reports the drift of the fresh
    fit against the model the current plan was built with.

    ``time_fn(nbytes) -> seconds`` is injectable so tests (and the
    benchmark's congestion-injection cell) can model an α×10 event
    without real network noise; production passes
    ``psum_time_fn(group)``.
    """

    base: MeasuredComm
    threshold: float = 0.25
    weight: float = 0.5
    probe_sizes: tuple[int, ...] = SLIM_COMM_SWEEP
    checks: int = 0
    refits: int = 0

    def __post_init__(self) -> None:
        self._reference = self.base.fit()

    @property
    def reference(self) -> AllReduceModel:
        """The fit the current plan is assumed to be built with."""
        return self._reference

    def check(self, time_fn: Callable[[int], float]) -> tuple[AllReduceModel, float, bool]:
        """One drift check: slim re-probe -> EWMA -> refit -> compare.

        Returns ``(fresh_fit, drift, drifted)``.  On ``drifted`` the fresh
        fit becomes the new reference — the caller is expected to re-plan
        (``replan_if_comm_drifted`` / ``Tuner.sweep``) with it.
        """
        self.checks += 1
        times = [float(time_fn(int(s))) for s in self.probe_sizes]
        self.base = self.base.update(self.probe_sizes, times, weight=self.weight)
        fit = self.base.fit()
        drift = comm_drift(self._reference, fit)
        drifted = drift > self.threshold
        if drifted:
            self.refits += 1
            self._reference = fit
        return fit, drift, drifted

    def replan(self, plan: Plan, fit: AllReduceModel, policy: str | None = None):
        """Convenience pass-through to ``replan_if_comm_drifted`` with this
        monitor's threshold (kept here so callers hold one knob)."""
        return replan_if_comm_drifted(plan, fit, threshold=self.threshold, policy=policy)

    # -- serialization ------------------------------------------------------

    def state_dict(self) -> dict[str, Any]:
        return {
            "sizes_bytes": list(self.base.sizes_bytes),
            "times_s": list(self.base.times_s),
            "axes": list(self.base.axes),
            "name": self.base.name,
            "threshold": self.threshold,
            "weight": self.weight,
            "probe_sizes": list(self.probe_sizes),
            "checks": self.checks,
            "refits": self.refits,
            "reference": {"a": self._reference.a, "b": self._reference.b,
                          "name": self._reference.name},
        }

    @classmethod
    def from_state_dict(cls, d: dict[str, Any]) -> "CommRefitter":
        out = cls(
            base=MeasuredComm(
                sizes_bytes=tuple(d["sizes_bytes"]),
                times_s=tuple(d["times_s"]),
                axes=tuple(d["axes"]),
                name=d.get("name", "measured_comm"),
            ),
            threshold=d["threshold"],
            weight=d["weight"],
            probe_sizes=tuple(d["probe_sizes"]),
            checks=d.get("checks", 0),
            refits=d.get("refits", 0),
        )
        ref = d.get("reference")
        if ref is not None:
            out._reference = AllReduceModel(a=ref["a"], b=ref["b"], name=ref["name"])
        return out


def psum_time_fn(group=None, dtype=torch.float32, repeats: int = 2,
                 device="cpu") -> Callable[[int], float]:
    """A ``time_fn`` for ``CommRefitter.check`` that times one real
    all-reduce per call on ``group`` (the default process group when
    None): one warm-up call, then the min of ``repeats``, the device
    synchronized before each clock read on CUDA; every rank gets rank 0's
    time, so every rank's refit drifts alike.

    One zero buffer per probe size is allocated once and reused for the
    lifetime of the returned callable (zeros stay zeros however often
    they are summed), so the periodic drift checks allocate nothing.  ``dist.all_reduce`` is called directly, outside the
    counted ``issue()`` seam.
    """
    itemsize = torch.empty((), dtype=dtype).element_size()
    buffers: dict[int, torch.Tensor] = {}
    on_cuda = torch.device(device).type == "cuda"

    def call(x: torch.Tensor) -> None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        if on_cuda:
            torch.cuda.synchronize(x.device)

    def time_one(nbytes: int) -> float:
        n = max(1, int(nbytes) // itemsize)
        if n not in buffers:
            buffers[n] = torch.zeros(n, dtype=dtype, device=device)
        x = buffers[n]
        call(x)  # warm
        best = float("inf")
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            call(x)
            best = min(best, time.perf_counter() - t0)
        return rank0_values([best], group, device)[0]

    return time_one
