"""Planning: scheduler-policy registry, the frozen ``Plan`` artifact, cost
sources and the closed-loop tuner.

    cost source  ──►  policy  ──►  Plan  ──►  sync buckets
         ▲                          │
         └── measured profile ◄── replan_if_drifted (online re-planning)

  * ``registry`` — scheduler policies (``register_policy`` / ``get_policy``).
  * ``plan``     — the frozen, JSON-serializable ``Plan`` artifact.
  * ``costs``    — ``AnalyticCosts`` (Eq. 18) and ``MeasuredCosts`` (unit
    probes, whole-step timing), ``replan_if_drifted``; on the comm side
    ``MeasuredComm`` (timed all-reduce α–β fit, journal §V-A Fig. 5(b)).
  * ``tuner``    — ``Tuner`` (registry-wide argmin-``t_iter`` sweep) and
    ``CommRefitter`` (amortized online (α, β) re-fit).
  * ``serve``    — the decode-side ``ServePlan`` (``build_serve_plan``,
    ``rebuild_serve_plan``, ``refit_serve_fit``).
"""

from .costs import (
    AnalyticCosts,
    CostSource,
    DEFAULT_COMM_SWEEP,
    MEASURED_HW,
    PROBE_OUTLIER_FACTOR,
    SLIM_COMM_SWEEP,
    MeasuredComm,
    MeasuredCosts,
    comm_drift,
    cost_drift,
    measure_comm_models,
    min_of_k,
    rank0_values,
    replan_if_comm_drifted,
    replan_if_drifted,
    time_collective_call,
)
from .plan import PLAN_FORMAT, Plan, build_plan
from .registry import (
    available_policies,
    build_schedule,
    get_policy,
    register_policy,
    resolve_policy_name,
)
from .serve import (
    SERVE_PLAN_FORMAT,
    ServePlan,
    build_serve_plan,
    decode_unit_costs,
    group_comparison_lines,
    make_group_collective,
    measure_serve_comm,
    rebuild_serve_plan,
    refit_serve_fit,
    serve_collective_time_fn,
    serve_fabric_fits,
    time_serve_groups,
)
from .tuner import (
    Candidate,
    CommRefitter,
    SweepRecord,
    Tuner,
    default_policies,
    psum_time_fn,
)

__all__ = [
    "AnalyticCosts",
    "CostSource",
    "DEFAULT_COMM_SWEEP",
    "MEASURED_HW",
    "PROBE_OUTLIER_FACTOR",
    "SLIM_COMM_SWEEP",
    "MeasuredComm",
    "MeasuredCosts",
    "comm_drift",
    "cost_drift",
    "measure_comm_models",
    "min_of_k",
    "rank0_values",
    "replan_if_comm_drifted",
    "replan_if_drifted",
    "time_collective_call",
    "PLAN_FORMAT",
    "Plan",
    "build_plan",
    "available_policies",
    "build_schedule",
    "get_policy",
    "register_policy",
    "resolve_policy_name",
    "SERVE_PLAN_FORMAT",
    "ServePlan",
    "build_serve_plan",
    "decode_unit_costs",
    "group_comparison_lines",
    "make_group_collective",
    "measure_serve_comm",
    "rebuild_serve_plan",
    "refit_serve_fit",
    "serve_collective_time_fn",
    "serve_fabric_fits",
    "time_serve_groups",
    "Candidate",
    "CommRefitter",
    "SweepRecord",
    "Tuner",
    "default_policies",
    "psum_time_fn",
]
