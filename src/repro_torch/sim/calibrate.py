"""Calibration: anchor the simulator to the committed benchmark records
(counterpart of ``repro/sim/calibrate.py``).

A what-if extrapolation to 512 hosts is worth reading only if the same
simulator, run at the small geometry the records were made at, gives
their numbers.  This module replays:

* every row of ``benchmarks/results/BENCH_planning.json``: the sweep's
  inputs rebuilt (the stacked layout at 16 model shards, the analytic unit
  costs at 8192 tokens a device, and the measured-3x profile) at the
  benchmark's ``{'data': 16, 'pod': 2}`` geometry, each row's committed
  ``t_iter_s`` to match;

* ``benchmarks/results/BENCH_serve_exec.json``: the serve replay runs one
  slot-bound decode workload at the plan-predicted step
  (``t_step_fixed_s + t_wire_s``) and at the record's ``observed_step_s``;
  their throughput ratio is the predicted-against-observed decode figure
  (the record's end-to-end ``tokens_per_s`` includes admission and
  prefill, which the plan does not price).

The records are the JAX package's, read and never written here.  They are
TPU-priced model outputs, the inputs that hold this simulator to the JAX
one, not measurements of any card.  Every comparison must land within
:data:`DEFAULT_RATIO_BUDGET`; ``CalibrationReport.ok`` is the gate.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

from .cluster import ClusterSpec
from .replay import replay_serve, simulate_train_iteration

#: The calibration error budget: simulated against committed ratio.
DEFAULT_RATIO_BUDGET = 1.25

#: The geometry every committed BENCH_planning row was priced at.
BENCH_PLANNING_CLUSTER = ClusterSpec(n_hosts=32, ici_size=16, fabric="tpu_v5e")

_RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "benchmarks" / "results"


@dataclasses.dataclass(frozen=True)
class CalibrationRow:
    """One simulated-against-observed comparison (ratio always >= 1)."""

    name: str
    predicted: float
    observed: float

    @property
    def ratio(self) -> float:
        lo, hi = sorted((self.predicted, self.observed))
        return hi / lo if lo > 0 else float("inf")

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "predicted": self.predicted,
            "observed": self.observed,
            "ratio": self.ratio,
        }


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """All calibration rows of one kind, and the budget."""

    kind: str
    rows: tuple[CalibrationRow, ...]
    budget: float = DEFAULT_RATIO_BUDGET

    @property
    def max_ratio(self) -> float:
        return max((r.ratio for r in self.rows), default=0.0)

    @property
    def ok(self) -> bool:
        return bool(self.rows) and self.max_ratio <= self.budget

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "kind": self.kind,
            "budget": self.budget,
            "max_ratio": self.max_ratio,
            "ok": self.ok,
            "rows": [r.to_json_dict() for r in self.rows],
        }


def _bench_planning_inputs(arch: str):
    """One arch's sweep inputs, as ``benchmarks/run.py``'s
    ``_arch_sweep_inputs`` builds them, with ``models.param_shapes`` in
    place of the JAX package's ``param_specs`` (the same sizes)."""
    from ..configs import get_config
    from ..core.cost_model import TPU_V5E
    from ..core.trainer import lm_unit_costs
    from ..models import param_shapes
    from ..planning import MEASURED_HW, MeasuredCosts

    cfg = get_config(arch)
    shapes = param_shapes(cfg)
    analytic = lm_unit_costs(cfg, shapes, tokens_per_device=8192, model_shards=16)
    measured = MeasuredCosts.from_unit_times(
        analytic,
        [c.t_b(TPU_V5E) * 3.0 for c in analytic],
        [c.t_f(TPU_V5E) * 3.0 for c in analytic],
        name="measured_3x",
    )
    return {
        "analytic": (analytic, TPU_V5E),
        "measured_3x": (measured.layer_costs(), MEASURED_HW),
    }


def calibrate_train(
    bench_path: str | pathlib.Path | None = None,
    budget: float = DEFAULT_RATIO_BUDGET,
) -> CalibrationReport:
    """Replay every committed BENCH_planning row through the simulator.

    For each (arch, policy, cost_source) row the policy re-plans on the
    rebuilt cost vector at the benchmark's geometry and the simulator
    replays one homogeneous iteration; its ``t_iter`` must match the
    committed ``t_iter_s`` within ``budget``."""
    from ..planning.registry import build_schedule

    path = pathlib.Path(bench_path or _RESULTS_DIR / "BENCH_planning.json")
    records = json.loads(path.read_text())
    ar = BENCH_PLANNING_CLUSTER.ar_model()
    mults = (1.0,) * BENCH_PLANNING_CLUSTER.n_hosts
    by_arch: dict[str, Any] = {}
    rows = []
    for rec in records:
        arch = rec["arch"]
        if arch not in by_arch:
            by_arch[arch] = _bench_planning_inputs(arch)
        costs, hw = by_arch[arch][rec["cost_source"]]
        schedule = build_schedule(rec["policy"], list(costs), ar, hw=hw)
        sim = simulate_train_iteration(
            schedule.groups, list(costs), ar, hw=hw, multipliers=mults
        )
        rows.append(
            CalibrationRow(
                name=f"{arch}/{rec['policy']}/{rec['cost_source']}/t_iter",
                predicted=sim.t_iter,
                observed=rec["t_iter_s"],
            )
        )
    return CalibrationReport(kind="train", rows=tuple(rows), budget=budget)


def calibrate_serve(
    bench_path: str | pathlib.Path | None = None,
    budget: float = DEFAULT_RATIO_BUDGET,
) -> CalibrationReport:
    """Replay the committed serve-exec step model through the simulator.

    One seeded slot-bound workload is simulated at the plan-predicted step
    (``t_step_fixed_s + t_wire_s``) and at the record's measured
    ``observed_step_s``; the two decode throughputs must agree within
    ``budget`` (they differ by the record's observed / predicted ratio)."""
    from ..serving.fleet import LoadSpec

    path = pathlib.Path(bench_path or _RESULTS_DIR / "BENCH_serve_exec.json")
    rec = json.loads(path.read_text())
    slots = int(rec["slots"])
    step_pred = float(rec["t_step_fixed_s"]) + float(rec["t_wire_s"])
    step_obs = float(rec["observed_step_s"])
    load = LoadSpec(
        n_requests=2 * slots,
        prompt_len=1,
        max_new_tokens=8,
        kind="trace",
        trace_arrivals_s=(0.0,) * (2 * slots),
        seed=0,
    )
    sim_pred = replay_serve(load, step_pred, n_replicas=1, slots=slots)
    sim_obs = replay_serve(load, step_obs, n_replicas=1, slots=slots)
    rows = (
        CalibrationRow(
            name=f"{rec['arch']}/decode_step_s",
            predicted=step_pred,
            observed=step_obs,
        ),
        CalibrationRow(
            name=f"{rec['arch']}/decode_tok_per_s",
            predicted=sim_pred.tokens_per_s,
            observed=sim_obs.tokens_per_s,
        ),
    )
    return CalibrationReport(kind="serve", rows=rows, budget=budget)
