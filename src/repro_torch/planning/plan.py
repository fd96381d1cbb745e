"""The frozen ``Plan`` artifact (counterpart of ``repro/planning/plan.py``;
the JSON format is the same, so a plan written by either package loads in
the other).

A Plan is everything the training system decided *before* the first step:
the communication-unit layout of the parameter pytree, the per-layer cost
vector those units were scheduled with, the α–β all-reduce model, the
hardware model the costs are expressed against, the resulting
gradient-merge schedule, and the scan segmentation derived from it —
plus provenance (which policy, which cost source) so a re-plan is
reproducible.

Plans serialize to JSON.  That makes them *artifacts*: an elastic
restart, a dry-run, or a benchmark reloads the plan instead of
recomputing Algorithm 1, and the measured-profile re-planning loop
(journal MG-WFBP, arXiv:1912.09268) diffs a live plan against measured
costs and emits a successor plan with updated provenance.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

from ..core.bucketing import (
    CommUnit,
    GroupArena,
    ParamLayout,
    group_arenas,
    layer_buckets_for_scan,
)
from ..core.comm_model import AllReduceModel
from ..core.cost_model import Hardware, LayerCost, TPU_V5E
from ..core.schedule import Schedule
from ..core.timeline import GroupTrace, TimelineResult
from .registry import build_schedule, resolve_policy_name

PLAN_FORMAT = 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """Immutable record of one planning decision.

    Attributes:
      layout:        communication units over the parameter pytree.
      costs:         per-unit LayerCost vector the schedule was built from,
                     expressed against ``hw``.
      ar_model:      affine all-reduce model used (Eq. 9).
      hw:            hardware model converting cost flops/bytes to seconds.
      schedule:      the gradient-merge schedule (with evaluated timeline).
      n_scan_stages: leading-axis length of the stacked scan (None for
                     layouts without a scan).
      segments:      (start, stop) scan segments derived from the schedule
                     (None when n_scan_stages is None).
      policy_opts:   extra keyword options the policy was run with (e.g.
                     ``fixed``'s ``bucket_bytes``); re-plans reuse them.
      provenance:    string map — at least ``policy`` and ``cost_source``.
    """

    layout: ParamLayout
    costs: tuple[LayerCost, ...]
    ar_model: AllReduceModel
    hw: Hardware
    schedule: Schedule
    n_scan_stages: int | None = None
    segments: tuple[tuple[int, int], ...] | None = None
    policy_opts: dict[str, Any] = dataclasses.field(default_factory=dict)
    provenance: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def num_layers(self) -> int:
        return self.layout.num_layers

    @property
    def policy(self) -> str:
        return self.provenance.get("policy", self.schedule.method)

    def describe(self) -> str:
        src = self.provenance.get("cost_source", "?")
        return (
            f"plan[{self.policy}|{src}|{self.hw.name}] "
            f"{self.schedule.describe()}"
        )

    def group_arenas(self, shapes: Any, comm_dtype: Any = "float32") -> list[GroupArena]:
        """Per-group flat wire layouts for this plan's schedule — what
        ``fuse='arena'`` packs into (``shapes``: the parameter pytree or a
        ``path -> shape`` callable; see ``bucketing.group_arenas``)."""
        return group_arenas(self.layout, self.schedule, shapes, comm_dtype)

    # -- serialization ------------------------------------------------------

    def to_json_dict(self) -> dict[str, Any]:
        sched: dict[str, Any] = {
            "groups": [list(g) for g in self.schedule.groups],
            "method": self.schedule.method,
            "result": None,
        }
        if self.schedule.result is not None:
            r = self.schedule.result
            sched["result"] = {
                "t_iter": r.t_iter,
                "t_f": r.t_f,
                "t_b": r.t_b,
                "t_comm_total": r.t_comm_total,
                "t_comm_exposed": r.t_comm_exposed,
                "groups": [
                    {
                        "layers": list(tr.layers),
                        "nbytes": tr.nbytes,
                        "avail": tr.avail,
                        "start": tr.start,
                        "finish": tr.finish,
                    }
                    for tr in r.groups
                ],
            }
        return {
            "format": PLAN_FORMAT,
            "layout": [
                {
                    "name": u.name,
                    "index": u.index,
                    "grad_bytes": u.grad_bytes,
                    "params": u.params,
                    "paths": [list(p) for p in u.paths],
                    "kind": u.kind,
                    "stack_index": u.stack_index,
                }
                for u in self.layout.units
            ],
            "costs": [dataclasses.asdict(c) for c in self.costs],
            "ar_model": dataclasses.asdict(self.ar_model),
            "hw": dataclasses.asdict(self.hw),
            "schedule": sched,
            "n_scan_stages": self.n_scan_stages,
            "segments": [list(s) for s in self.segments] if self.segments is not None else None,
            "policy_opts": dict(self.policy_opts),
            "provenance": dict(self.provenance),
        }

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_json_dict(), indent=indent)

    @classmethod
    def from_json_dict(cls, d: dict[str, Any]) -> "Plan":
        if d.get("format") != PLAN_FORMAT:
            raise ValueError(f"unsupported plan format {d.get('format')!r}")
        units = tuple(
            CommUnit(
                name=u["name"],
                index=u["index"],
                grad_bytes=u["grad_bytes"],
                params=u["params"],
                paths=tuple(tuple(p) for p in u["paths"]),
                kind=u["kind"],
                stack_index=u["stack_index"],
            )
            for u in d["layout"]
        )
        result = None
        if d["schedule"]["result"] is not None:
            r = d["schedule"]["result"]
            result = TimelineResult(
                t_iter=r["t_iter"],
                t_f=r["t_f"],
                t_b=r["t_b"],
                t_comm_total=r["t_comm_total"],
                t_comm_exposed=r["t_comm_exposed"],
                groups=tuple(
                    GroupTrace(
                        layers=tuple(tr["layers"]),
                        nbytes=tr["nbytes"],
                        avail=tr["avail"],
                        start=tr["start"],
                        finish=tr["finish"],
                    )
                    for tr in r["groups"]
                ),
            )
        schedule = Schedule(
            groups=tuple(tuple(g) for g in d["schedule"]["groups"]),
            method=d["schedule"]["method"],
            result=result,
        )
        return cls(
            layout=ParamLayout(units=units),
            costs=tuple(LayerCost(**c) for c in d["costs"]),
            ar_model=AllReduceModel(**d["ar_model"]),
            hw=Hardware(**d["hw"]),
            schedule=schedule,
            n_scan_stages=d["n_scan_stages"],
            segments=tuple(tuple(s) for s in d["segments"]) if d["segments"] is not None else None,
            policy_opts=dict(d.get("policy_opts", {})),
            provenance=dict(d["provenance"]),
        )

    @classmethod
    def from_json(cls, text: str) -> "Plan":
        return cls.from_json_dict(json.loads(text))

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json())
        return p

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "Plan":
        return cls.from_json(pathlib.Path(path).read_text())


def build_plan(
    layout: ParamLayout,
    costs: list[LayerCost],
    ar_model: AllReduceModel,
    *,
    policy: str = "mg_wfbp",
    hw: Hardware = TPU_V5E,
    n_scan_stages: int | None = None,
    cost_source: str = "analytic",
    policy_opts: dict[str, Any] | None = None,
    provenance: dict[str, str] | None = None,
) -> Plan:
    """Cost vector + policy -> evaluated Plan (the cost-source -> policy ->
    plan leg of the planning lifecycle)."""
    if len(costs) != layout.num_layers:
        raise ValueError(
            f"cost vector covers {len(costs)} units, layout has {layout.num_layers}"
        )
    policy = resolve_policy_name(policy)
    schedule = build_schedule(policy, costs, ar_model, hw=hw, **(policy_opts or {}))
    segments = (
        layer_buckets_for_scan(schedule, n_scan_stages)
        if n_scan_stages is not None
        else None
    )
    prov = {"policy": policy, "cost_source": cost_source}
    if provenance:
        prov.update(provenance)
    return Plan(
        layout=layout,
        costs=tuple(costs),
        ar_model=ar_model,
        hw=hw,
        schedule=schedule,
        n_scan_stages=n_scan_stages,
        segments=segments,
        policy_opts=dict(policy_opts or {}),
        provenance=prov,
    )
