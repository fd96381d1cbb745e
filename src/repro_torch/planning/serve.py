"""The Plan lifecycle extended to serving: the frozen ``ServePlan``
(counterpart of ``repro/planning/serve.py``).

Decode has the same shape of problem as training: per-stage compute runs
sequentially while per-stage collectives — the KV-cache all-gather of
TP-sharded attention, the expert all-to-all of EP MoE — can overlap and
*merge*.  Eq. 9/10 apply verbatim: each collective costs ``a + b·M`` on
the serving fabric, so merging adjacent stages' messages recovers ``a``
per merge exactly as in training.  This module reuses the planner
machinery end to end:

  * ``decode_unit_costs`` builds the per-stage cost vector (decode flops
    per token step + collective payload bytes per stage);
  * ``build_serve_plan`` selects the dominant decode collective
    (``all_to_all`` for MoE archs, ``all_gather`` otherwise), prices it
    through a registry ``Fabric`` (``fabric.cost(op, axis_sizes)``), and
    runs a registered scheduler policy into a frozen, JSON-serializable
    ``ServePlan`` whose JSON either package reads;
  * ``rebuild_serve_plan`` / ``refit_serve_fit`` re-plan at a new (α, β).

The executable leg runs over a tensor-parallel process group:
``make_group_collective`` issues one collective per scheduled group
(``serving.sharded``'s decode step drives it), and
``serve_collective_time_fn``, ``measure_serve_comm``,
``serve_fabric_fits`` and ``time_serve_groups`` time real serve
collectives.  Where the JAX functions take a ``Mesh`` and an axis name,
these take a ``DeviceMesh`` (``launch.mesh``) and a dimension name, whose
group is ``mesh.get_group(axis)``.  Every collective goes through the
counted ``fabric.ops.issue``.

Consumers: ``serving.engine.ServingEngine`` carries the plan,
``launch/serve.py`` builds and saves it (``--fabric`` / ``--plan-out``),
``serving.resilience`` re-plans it on a degraded fabric and
``serving.fleet`` prices admission and scaling with it.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..core.comm_model import AllReduceModel, fit_affine
from ..core.cost_model import TPU_V5E, Hardware, LayerCost
from ..core.schedule import Schedule
from ..core.timeline import GroupTrace, TimelineResult
from ..fabric import Collective, Fabric, get_fabric
from ..fabric.ops import issue
from .costs import (
    DEFAULT_COMM_SWEEP,
    SLIM_COMM_SWEEP,
    MeasuredComm,
    rank0_values,
    time_collective_call,
)
from .registry import build_schedule, resolve_policy_name

SERVE_PLAN_FORMAT = 1


def _tree_size(tree: Any) -> int:
    """Elements of every tensor leaf of a nested dict (``param_shapes``)."""
    if isinstance(tree, dict):
        return sum(_tree_size(v) for v in tree.values())
    return int(tree.numel())


def decode_unit_costs(
    cfg: Any,
    param_shapes: Any,
    batch_rows: int,
    *,
    cache_dtype_bytes: int = 2,
    act_dtype_bytes: int = 2,
) -> list[LayerCost]:
    """Per-scan-stage decode cost vector (one token per row per step).

    ``grad_bytes`` is repurposed as the stage's *collective payload* per
    decode step: the fresh KV rows every attention layer in the stage
    must all-gather across the TP shards, plus (MoE) the dispatch+combine
    activations of the expert all-to-all.  ``bwd_flops`` carries the
    stage's decode compute (the timeline's sequential axis; ``t_f`` is 0
    for decode).  Head/embed run outside the scan and ship nothing, so
    units are exactly the ``n_stages`` scan stages — what
    ``make_group_collective`` slices a stacked cache tree by.
    """
    stage_p = _tree_size(param_shapes["stages"]) // cfg.n_stages
    # every non-recurrent block carries an attention sublayer with a KV
    # cache ('moe' included)
    attn_layers = sum(1 for kind in cfg.pattern if kind not in ("rwkv", "rec"))
    kv_row = (
        cfg.attention.n_kv_heads * cfg.attention.head_dim if cfg.attention else 0
    )
    # K and V, one fresh row per sequence per attention layer per step
    kv_bytes = 2 * batch_rows * kv_row * cache_dtype_bytes * attn_layers
    a2a_bytes = 0
    active = 1.0
    if cfg.moe is not None:
        active = cfg.moe.top_k / cfg.moe.n_experts
        active = 0.25 + 0.75 * active if active < 1 else 1.0
        # dispatch + combine of top_k expert activations per token
        a2a_bytes = (
            2 * batch_rows * cfg.moe.top_k * cfg.d_model * act_dtype_bytes * len(cfg.pattern)
        )
    out = []
    for i in range(cfg.n_stages):
        out.append(
            LayerCost(
                name=f"stage_{i}",
                params=stage_p,
                grad_bytes=max(1, kv_bytes + a2a_bytes),
                bwd_flops=2.0 * stage_p * batch_rows * active,
                fwd_flops=0.0,
            )
        )
    return out


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """Immutable record of one decode-side scheduling decision.

    Attributes:
      arch:       architecture name the plan was built for.
      op:         the scheduled collective (``Collective`` value string).
      axis:       mesh axis the collective runs over at execution time.
      axis_sizes: mesh axis sizes the fabric priced the op at.
      fabric:     registry name of the fabric the model came from.
      costs:      per-stage decode cost vector (see ``decode_unit_costs``).
      model:      affine (a, b) model of ``op`` on the fabric.
      hw:         hardware model converting cost flops to seconds.
      schedule:   the merge schedule over stages (with evaluated timeline).
      t_step_fixed: measured per-step fixed (dispatch+compute) seconds —
                  the startup term of the *step*, not the wire.  0.0
                  until a probe fills it (``ServingEngine.calibrate_plan``
                  / ``with_step_fixed``); ``predicted_step_time`` adds it
                  to the wire timeline so predictions stay honest.
      provenance: string map — at least ``policy`` and ``fabric``.
    """

    arch: str
    op: str
    axis: str
    axis_sizes: dict[str, int]
    fabric: str
    costs: tuple[LayerCost, ...]
    model: AllReduceModel
    hw: Hardware
    schedule: Schedule
    t_step_fixed: float = 0.0
    provenance: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def num_stages(self) -> int:
        return len(self.costs)

    @property
    def policy(self) -> str:
        return self.provenance.get("policy", self.schedule.method)

    def predicted_step_time(self) -> float | None:
        """Modeled decode-step seconds: the evaluated wire timeline
        (``schedule.result.t_iter``) plus the measured per-step fixed
        term — the two-term cost model MG-WFBP's startup/bandwidth
        decomposition suggests for the step itself.  None before the
        schedule is evaluated."""
        if self.schedule.result is None:
            return None
        return self.schedule.result.t_iter + self.t_step_fixed

    def predicted_completion_s(self, n_tokens: int) -> float | None:
        """Modeled seconds for one request to decode ``n_tokens`` more
        tokens: the engine emits one token per request per step, so a
        request's remaining work is ``n_tokens`` steps no matter how many
        rows share the batch.  Fleet-level admission prices a request's
        ETA with this (queue wait + this) against its deadline.  None
        before the schedule is evaluated."""
        step = self.predicted_step_time()
        return None if step is None else step * max(0, int(n_tokens))

    def capacity_tok_per_s(self, rows: int) -> float | None:
        """Modeled steady-state throughput of one replica running this
        plan with ``rows`` busy decode slots: ``rows`` tokens per
        predicted step.  The fleet watchdog prices scale-up/down
        decisions with this — adding a replica buys exactly this much
        capacity, removing one sheds it.  None before the schedule is
        evaluated."""
        step = self.predicted_step_time()
        if step is None or step <= 0:
            return None
        return int(rows) / step

    def with_step_fixed(self, t_step_fixed: float) -> "ServePlan":
        """A copy of this plan with the measured fixed (dispatch+compute)
        per-step term installed (provenance records the source)."""
        prov = dict(self.provenance)
        prov["t_step_fixed_source"] = "probe"
        return dataclasses.replace(
            self, t_step_fixed=float(t_step_fixed), provenance=prov
        )

    def group_summaries(self) -> tuple[dict[str, Any], ...]:
        """Per scheduled group: stage span, wire bytes, the fabric's
        predicted collective seconds (``a + b·M`` at the group's
        payload), and the plan-level fixed term (``t_fixed_s``, same on
        every row) — the rows ``describe()`` renders and the serve
        benchmarks compare measured gather times against."""
        if self.schedule.result is None:
            return ()
        return tuple(
            {
                "stages": tr.layers,
                "nbytes": tr.nbytes,
                "t_pred_s": self.model(tr.nbytes),
                "t_fixed_s": self.t_step_fixed,
                "start_s": tr.start,
                "finish_s": tr.finish,
            }
            for tr in self.schedule.result.groups
        )

    def describe(self) -> str:
        """Human-readable plan summary including the fixed-vs-wire step
        decomposition and per-group predicted collective times and wire
        bytes, so a ``--plan-out`` artifact is reviewable without
        loading the JSON."""
        head = (
            f"serve_plan[{self.policy}|{self.fabric}|{self.op}] "
            f"{self.schedule.describe()}"
        )
        if self.schedule.result is not None:
            wire = self.schedule.result.t_iter
            head += (
                f" step=fixed {self.t_step_fixed * 1e6:.1f}us"
                f" + wire {wire * 1e6:.1f}us"
                f" = {(self.t_step_fixed + wire) * 1e6:.1f}us"
            )
        rows = self.group_summaries()
        if not rows:
            return head
        lines = [head]
        for g in rows:
            lo, hi = g["stages"]
            lines.append(
                f"  group[{lo}..{hi}] wire={g['nbytes']}B "
                f"t_pred={g['t_pred_s'] * 1e6:.1f}us "
                f"start={g['start_s'] * 1e6:.1f}us "
                f"finish={g['finish_s'] * 1e6:.1f}us"
            )
        return "\n".join(lines)

    # -- serialization (mirrors planning.Plan) ------------------------------

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
            "format": SERVE_PLAN_FORMAT,
            "arch": self.arch,
            "op": self.op,
            "axis": self.axis,
            "axis_sizes": dict(self.axis_sizes),
            "fabric": self.fabric,
            "costs": [dataclasses.asdict(c) for c in self.costs],
            "model": dataclasses.asdict(self.model),
            "hw": dataclasses.asdict(self.hw),
            "schedule": sched,
            "t_step_fixed": self.t_step_fixed,
            "provenance": dict(self.provenance),
        }

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_json_dict(), indent=indent)

    @classmethod
    def from_json_dict(cls, d: dict[str, Any]) -> "ServePlan":
        if d.get("format") != SERVE_PLAN_FORMAT:
            raise ValueError(f"unsupported serve plan format {d.get('format')!r}")
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
        return cls(
            arch=d["arch"],
            op=d["op"],
            axis=d["axis"],
            axis_sizes={k: int(v) for k, v in d["axis_sizes"].items()},
            fabric=d["fabric"],
            costs=tuple(LayerCost(**c) for c in d["costs"]),
            model=AllReduceModel(**d["model"]),
            hw=Hardware(**d["hw"]),
            schedule=Schedule(
                groups=tuple(tuple(g) for g in d["schedule"]["groups"]),
                method=d["schedule"]["method"],
                result=result,
            ),
            # optional: plans saved before the fixed-term model load as 0.0
            t_step_fixed=float(d.get("t_step_fixed", 0.0)),
            provenance=dict(d["provenance"]),
        )

    @classmethod
    def from_json(cls, text: str) -> "ServePlan":
        return cls.from_json_dict(json.loads(text))

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json())
        return p

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "ServePlan":
        return cls.from_json(pathlib.Path(path).read_text())


def build_serve_plan(
    cfg: Any,
    param_shapes: Any,
    fabric: str | Fabric,
    axis_sizes: dict[str, int],
    *,
    batch_rows: int,
    policy: str = "mg_wfbp",
    hw: Hardware = TPU_V5E,
    axis: str = "model",
    op: Collective | str | None = None,
    policy_opts: dict[str, Any] | None = None,
    provenance: dict[str, str] | None = None,
    cache_dtype_bytes: int = 2,
    act_dtype_bytes: int = 2,
) -> ServePlan:
    """Cost vector + fabric + policy -> evaluated ServePlan.

    The collective defaults to the arch's dominant decode op
    (``all_to_all`` for MoE, ``all_gather`` otherwise); any registered
    fabric prices it — the same registry, the same merge math, training
    and serving.  ``cache_dtype_bytes``/``act_dtype_bytes`` size the wire
    payload: the production default is bf16 (2); pass 4 when pricing an
    engine whose caches run fp32 (the reduced CPU engines) so measured
    group collectives compare against the bytes the step actually ships.

    Example::

        cfg = get_config("tinyllama-1.1b")
        plan = build_serve_plan(cfg, param_shapes(cfg), "gpu_nccl",
                                {"model": 8}, batch_rows=16)
        print(plan.describe())          # per-group bytes + predicted times
    """
    fab = get_fabric(fabric)
    if op is None:
        op = Collective.ALL_TO_ALL if cfg.moe is not None else Collective.ALL_GATHER
    op = Collective(op)
    model = fab.cost(op, axis_sizes)
    costs = decode_unit_costs(
        cfg, param_shapes, batch_rows,
        cache_dtype_bytes=cache_dtype_bytes, act_dtype_bytes=act_dtype_bytes,
    )
    policy = resolve_policy_name(policy)
    schedule = build_schedule(
        policy, costs, model, hw=hw, t_f=0.0, **(policy_opts or {})
    )
    prov = {"policy": policy, "fabric": fab.name, "op": op.value}
    if provenance:
        prov.update(provenance)
    return ServePlan(
        arch=cfg.name,
        op=op.value,
        axis=axis,
        axis_sizes=dict(axis_sizes),
        fabric=fab.name,
        costs=tuple(costs),
        model=model,
        hw=hw,
        schedule=schedule,
        provenance=prov,
    )


def rebuild_serve_plan(
    plan: ServePlan,
    model: AllReduceModel,
    *,
    policy: str | None = None,
    trigger: str = "degraded_fabric",
) -> ServePlan:
    """Re-plan an existing ``ServePlan`` at a new (α, β) — the
    degraded-fabric replan.

    The cost vector, hardware model, and policy are reused unchanged;
    only the collective model is swapped and the merge schedule re-solved
    — MG-WFBP's merge decision is a function of (α, β), so when the wire
    slows down (a flaky link, congestion, a failed NIC renegotiating
    speed) the *merge set itself* must be allowed to change, not just the
    predicted times (pinned by ``tests/test_torch_resilience.py``).  The
    measured ``t_step_fixed`` carries over — degradation is modeled on
    the wire, the compute+dispatch term is untouched.  Provenance records
    the trigger and the model it replaced so a ``--plan-out`` artifact
    shows the replan happened.

    ``serving.resilience.resilient_serve_loop`` calls this when its
    ``StragglerMonitor`` flags sustained step-time degradation, with
    ``model`` coming from ``refit_serve_fit`` over the loop's
    ``refit_time_fn`` (by default the loop-entry plan's pricing, scaled by
    the chaos injector on a degraded fabric; ``serve_collective_time_fn``
    gives live probes of a real group)."""
    pol = resolve_policy_name(policy or plan.policy)
    schedule = build_schedule(pol, list(plan.costs), model, hw=plan.hw, t_f=0.0)
    prov = dict(plan.provenance)
    prov.update({
        "policy": pol,
        "refit": trigger,
        "replaced_model": plan.model.name or "",
    })
    return dataclasses.replace(
        plan, model=model, schedule=schedule, provenance=prov
    )


def refit_serve_fit(
    time_fn,
    probe_sizes: tuple[int, ...] | None = None,
    name: str = "serve_refit",
) -> AllReduceModel:
    """Slim serve-side (α, β) re-fit — the ``CommRefitter`` pattern
    applied through the serve wire.

    ``time_fn(nbytes) -> seconds`` prices one collective at one message
    size; a few probe sizes (``SLIM_COMM_SWEEP`` by default: one small
    for α, one large for β) are timed and least-squares fitted.  Pass
    ``serve_collective_time_fn(mesh, op)`` for live measurements, or any
    injectable stand-in (``ChaosInjector.wrap_time_fn`` in tests) — the
    same seam ``planning.tuner.CommRefitter`` uses on the train side."""
    sizes = tuple(int(s) for s in (probe_sizes or SLIM_COMM_SWEEP))
    return fit_affine(
        sizes, tuple(float(time_fn(s)) for s in sizes), name=name
    )


def axis_group(mesh: DeviceMesh, axis: str) -> dist.ProcessGroup:
    """The process group behind ``mesh``'s dimension ``axis``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a DeviceMesh, got {type(mesh).__name__}")
    return mesh.get_group(axis)


def _group_device(group: dist.ProcessGroup) -> torch.device:
    """The device a group's collectives take tensors on: the current card
    under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_group_collective(plan: ServePlan, group: dist.ProcessGroup | None = None):
    """Executable serve wire: ``fn(stacked) -> list`` issuing exactly ONE
    collective of ``plan.op`` per scheduled group over ``group`` (the
    default group when None).

    ``stacked`` is a per-stage payload with the stage axis leading
    (``(n_stages, ...)``: the fresh KV rows of every stage).  Group
    ``(lo, hi)`` (1-indexed) flattens ``stacked[lo-1:hi]`` into one
    buffer and ships it: an ``all_gather`` returns ``(N, L)`` (every
    rank's buffer, rank-major), an ``all_to_all`` pads the buffer with
    zeros to a multiple of the group size N (a local pad, never a second
    call) and returns ``(N, L/N)``, an ``all_reduce`` returns the summed
    ``(L,)``.  Each group's output buffer is allocated once per payload
    shape and reused by every later call (a CUDA graph replays over
    static buffers), so an output is valid until the next call.
    """
    op = Collective(plan.op)
    if op is Collective.REDUCE_SCATTER:
        raise ValueError("serve groups issue all_gather, all_to_all or all_reduce")
    groups = plan.schedule.groups
    n = dist.get_world_size(group)
    buffers: dict[tuple, list[torch.Tensor]] = {}

    def out_shape(lo: int, hi: int, stacked: torch.Tensor) -> tuple[int, ...]:
        length = (hi - lo + 1) * (stacked[0].numel() if stacked.shape[0] else 0)
        if op is Collective.ALL_GATHER:
            return (n * length,)  # flat, as gloo's all-gather wants it
        if op is Collective.ALL_TO_ALL:
            return (n, -(-length // n))
        return (length,)

    def run(stacked: torch.Tensor) -> list[torch.Tensor]:
        if stacked.shape[0] != plan.num_stages:
            raise ValueError(
                f"payload has {stacked.shape[0]} stages, plan has {plan.num_stages}")
        key = (tuple(stacked.shape), stacked.dtype, stacked.device)
        if key not in buffers:
            buffers[key] = [torch.empty(out_shape(lo, hi, stacked), dtype=stacked.dtype,
                                        device=stacked.device) for lo, hi in groups]
        outs = buffers[key]
        for (lo, hi), out in zip(groups, outs):
            flat = stacked[lo - 1 : hi].reshape(-1)
            if op is Collective.ALL_TO_ALL:
                pad = (-flat.numel()) % n
                if pad:
                    flat = F.pad(flat, (0, pad))
                issue(op, flat.reshape(n, -1).contiguous(), group, out=out)
            elif op is Collective.ALL_GATHER:
                issue(op, flat.contiguous(), group, out=out)
            else:
                out.copy_(flat)
                issue(op, out, group)
        if op is Collective.ALL_GATHER:
            return [out.view(n, -1) for out in outs]
        return outs

    return run


def serve_collective_time_fn(mesh: DeviceMesh, op: Collective | str,
                             axis: str = "model", repeats: int = 3):
    """``time_fn(nbytes) -> seconds`` pricing one real serve collective
    over ``mesh``'s ``axis``: the live probe behind ``refit_serve_fit``
    (the serve-side ``psum_time_fn``)."""
    op = Collective(op)

    def fn(nbytes: int) -> float:
        return measure_serve_comm(mesh, op, (axis,), sizes_bytes=(int(nbytes),),
                                  repeats=repeats).times_s[0]

    return fn


# ---------------------------------------------------------------------------
# Measured serve fabrics: time the real decode collectives
# ---------------------------------------------------------------------------


def measure_serve_comm(
    mesh: DeviceMesh,
    op: Collective | str = Collective.ALL_GATHER,
    axes: tuple[str, ...] = ("model",),
    sizes_bytes: tuple[int, ...] | None = None,
    dtype: torch.dtype | None = None,
    repeats: int = 3,
    name: str | None = None,
) -> MeasuredComm:
    """Time real serve collectives over a size sweep on ``mesh``'s axis.

    The serve-side analogue of ``MeasuredComm.time_psums``: one buffer per
    size on the group's device, one discarded call, then the min of
    ``repeats`` timed calls (``time_collective_call``), every sample rank
    0's on every rank so that all ranks make the same calls.
    ``sizes_bytes`` are the *message* bytes ``M`` the ``ServePlan``
    timeline prices: for ``all_gather`` the gathered result (each rank
    contributes ``M/N``), for ``all_to_all`` the full local volume.  So the
    returned ``MeasuredComm``'s ``fit()`` is an (α, β) model directly
    comparable to ``fabric.cost(op, axis_sizes)``.
    """
    if len(axes) != 1:
        raise ValueError(f"serve collectives run over one axis, got {axes}")
    op = Collective(op)
    if op is Collective.REDUCE_SCATTER:
        raise ValueError("serve collectives are all_gather, all_to_all or all_reduce")
    sizes_bytes = DEFAULT_COMM_SWEEP if sizes_bytes is None else tuple(sizes_bytes)
    dtype = torch.float32 if dtype is None else dtype
    group = axis_group(mesh, axes[0])
    n = dist.get_world_size(group)
    device = _group_device(group)
    itemsize = torch.empty((), dtype=dtype).element_size()

    def agree(t: float) -> float:
        return rank0_values([t], group, device)[0]

    times = []
    for nb in sizes_bytes:
        if op is Collective.ALL_GATHER:
            x = torch.ones(max(1, int(nb) // (itemsize * n)), dtype=dtype, device=device)
            out = torch.empty(n * x.numel(), dtype=dtype, device=device)
        else:
            elems = max(n, int(nb) // itemsize)
            elems -= elems % n
            shape = (n, elems // n) if op is Collective.ALL_TO_ALL else (elems,)
            x = torch.ones(shape, dtype=dtype, device=device)
            out = torch.empty_like(x) if op is Collective.ALL_TO_ALL else None

        def call(v: torch.Tensor, out=out) -> None:
            issue(op, v, group, out=out)

        times.append(time_collective_call(call, x, repeats, agree=agree))
    return MeasuredComm(
        sizes_bytes=tuple(int(s) for s in sizes_bytes),
        times_s=tuple(times),
        axes=tuple(axes),
        name=name or f"{op.value}@{'+'.join(axes)}",
    )


def serve_fabric_fits(
    mesh,
    ops: tuple[Collective | str, ...] = (Collective.ALL_GATHER,),
    axes: tuple[str, ...] = ("model",),
    **kwargs: Any,
) -> dict[str, AllReduceModel]:
    """Op-specific measured fits keyed for ``fabric.MeasuredFabric``.

    Times each op's sweep on ``mesh`` and returns
    ``{'all_gather@model': AllReduceModel, ...}`` — drop the dict into
    ``MeasuredFabric(models=...)`` (or ``.with_fits``) and the registry
    prices serve plans from live decode-collective measurements, the
    serve-side analogue of the ``CommRefitter`` loop::

        fits = serve_fabric_fits(mesh, ops=("all_gather",))
        fab = MeasuredFabric(models=fits, name="measured_serve")
        plan = build_serve_plan(cfg, shapes, fab, {"model": 8}, batch_rows=4)
    """
    key = "+".join(sorted(axes))
    return {
        f"{Collective(op).value}@{key}": measure_serve_comm(
            mesh, op, axes, **kwargs
        ).fit()
        for op in ops
    }


def group_comparison_lines(
    plan: ServePlan, measured_s: tuple[float, ...]
) -> list[str]:
    """Render ``group[lo..hi] wire=..B pred=..us meas=..us`` rows pairing
    ``group_summaries()`` with ``time_serve_groups`` output — the one
    predicted-vs-measured table ``launch/serve.py --measure-comm`` and
    ``examples/serve_decode.py`` both print.  A calibrated plan
    (``t_step_fixed > 0``) leads with the fixed-vs-wire step
    decomposition so the per-group wire rows read against the honest
    whole-step prediction."""
    lines = []
    if plan.t_step_fixed > 0 and plan.schedule.result is not None:
        wire = plan.schedule.result.t_iter
        lines.append(
            f"step: fixed={plan.t_step_fixed * 1e6:8.1f}us "
            f"wire={wire * 1e6:8.1f}us "
            f"pred_total={(plan.t_step_fixed + wire) * 1e6:8.1f}us"
        )
    for g, t_meas in zip(plan.group_summaries(), measured_s):
        lo, hi = g["stages"]
        lines.append(
            f"group[{lo}..{hi}] wire={g['nbytes']}B "
            f"pred={g['t_pred_s'] * 1e6:8.1f}us "
            f"meas={t_meas * 1e6:8.1f}us"
        )
    return lines


def time_serve_groups(plan: ServePlan, mesh: DeviceMesh, *,
                      axis: str | None = None, repeats: int = 3,
                      dtype: torch.dtype | None = None) -> tuple[float, ...]:
    """Measured seconds per scheduled serve group: one real collective of
    the plan's op at each group's exact wire payload, in schedule order —
    what ``ServeTimer.group_times`` holds and ``group_comparison_lines``
    sets beside ``group_summaries()``'s predictions."""
    if plan.schedule.result is None:
        raise ValueError("plan has no evaluated timeline to read group bytes from")
    sizes = tuple(max(1, tr.nbytes) for tr in plan.schedule.result.groups)
    mc = measure_serve_comm(mesh, plan.op, (axis or plan.axis,), sizes_bytes=sizes,
                            repeats=repeats, dtype=dtype, name="serve_groups")
    return mc.times_s
