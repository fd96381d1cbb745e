"""Training launcher: the MG-WFBP engine + the synthetic data pipeline
(counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 20 --fuse arena --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given.  Under ``torchrun``
the process group comes from its environment (one rank per process,
``nccl`` on CUDA, ``gloo`` on the CPU); otherwise the launcher makes a
world of one on a local ``FileStore``.

Planning lifecycle (journal MG-WFBP's online re-planning):

  * the engine builds (or loads, ``--plan-in``) a frozen ``Plan``;
  * ``--measure-comm`` fits (α, β) from timed all-reduces on the process
    group (a ``MeasuredFabric``) instead of the ``--fabric`` preset;
  * ``--autotune`` closes the loop: per-unit probes
    (``runtime/timeline.py``) feed ``MeasuredCosts.from_segment_times``
    and a registry-wide ``planning.Tuner`` sweep picks the argmin
    predicted-t_iter plan, at startup and on drift;
  * every ``--replan-every`` steps the measured profile (per-unit probe
    times under --autotune, else the median step time's uniform rescale)
    drives ``replan_if_drifted`` / a tuner sweep (threshold
    ``--replan-threshold``);
  * every ``--comm-refit-every`` steps a slim timed all-reduce sweep is
    exponentially weighted into the (α, β) fit (``CommRefitter``); past
    ``--comm-drift-threshold`` the plan search reruns under the fresh fit;
  * a re-plan builds a new train step and hands it the optimizer state and
    the error-feedback residual of the old one, whose hooks it removes;
  * the steps run inside ``runtime.resilient_loop``: every ``--ckpt-every``
    steps an atomic checkpoint (weights, optimizer state, the
    error-feedback residual of every rank) lands in ``--ckpt-dir`` with
    the live plan and the tuner state beside it; on a failure the loop
    restores the latest complete checkpoint, resumes under the stored plan
    (or re-plans / re-sweeps when there is none) with the tuner's history
    and the ``CommRefitter``'s observations, and rebuilds the step, up to
    ``--max-restarts`` times;
  * ``--dryrun N`` runs N steps under a ``TraceRecorder`` and prints the
    measured overlap of comm and backward (``--trace-out`` keeps the
    Chrome trace), outside the loop: no checkpoint, no restart.

Every rank must adopt the same plan, or the ranks' all-reduces no longer
match.  So every measured input of a plan decision (unit seconds, comm
observations, the median step time) is rank 0's on every rank
(``planning.rank0_values``: a plain ``dist.broadcast``, outside the
counted ``issue()`` seam) before it is used; so is the checkpoint a
restart restores (rank 0's latest).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist

from ..checkpoint import AsyncCheckpointer, load_plan, load_tuner_state
from ..configs import ARCH_NAMES, get_config, get_reduced
from ..core.bucketing import dtype_name
from ..core.comm_model import AllReduceModel
from ..core.profiler import TraceRecorder, overlap_report
from ..core.sync import SyncConfig
from ..core.trainer import MGWFBPEngine, TrainStep, batch_to_device
from ..data import DataConfig, SyntheticLMStream, make_stream
from ..devices import resolve_device
from ..fabric import MeasuredFabric, available_fabrics, get_fabric
from ..fabric.ops import issue
from ..kernels import launch_counts
from ..models.common import ArchConfig
from ..models.transformer import Transformer, param_shapes
from ..optim import make_optimizer
from ..optim.optimizers import Optimizer
from ..planning import (
    DEFAULT_COMM_SWEEP,
    CommRefitter,
    MeasuredComm,
    MeasuredCosts,
    Plan,
    SweepRecord,
    Tuner,
    available_policies,
    cost_drift,
    psum_time_fn,
    rank0_values,
)
from ..runtime import (
    RunState,
    StepTimer,
    StragglerMonitor,
    UnitProfile,
    agreed_latest_step,
    make_unit_probes,
    probe_unit_times,
    resilient_loop,
)
from .mesh import ProcessWorld


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config, f32 params")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch (split over ranks)")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--policy", "--method", dest="policy", default=None,
                    choices=list(available_policies()),
                    help="scheduler policy (default mg_wfbp); with --plan-in it must "
                         "match the plan's policy; ignored under --autotune (the sweep "
                         "picks)")
    ap.add_argument("--comm-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--compression", default=None, choices=["bf16", "bf16_ef"],
                    help="wire compression (default: follows --comm-dtype); bf16_ef "
                         "carries the error-feedback residual (requires --fuse arena)")
    ap.add_argument("--fuse", default="concat", choices=["concat", "variadic", "arena"],
                    help="wire layout: concat (one flat buffer, copy each way), variadic "
                         "(one coalesced all-reduce over the group's tensors) or arena "
                         "(the comm_pack pack/unpack kernels)")
    ap.add_argument("--virtual-dp", type=int, default=32,
                    help="DP size assumed by the α–β schedule model")
    ap.add_argument("--fabric", default="tpu_v5e", choices=available_fabrics(),
                    help="interconnect preset pricing the DP all-reduce")
    ap.add_argument("--measure-comm", action="store_true",
                    help="fit (α, β) from timed all-reduces on the live process group "
                         "(a MeasuredFabric, journal §V-A) instead of the --fabric preset "
                         "at --virtual-dp")
    ap.add_argument("--autotune", action="store_true",
                    help="closed-loop auto-tuner: per-unit probes feed MeasuredCosts, and "
                         "a registry-wide Tuner sweep picks the argmin predicted-t_iter "
                         "plan at startup and on drift")
    ap.add_argument("--comm-refit-every", type=int, default=0,
                    help="steps between slim timed all-reduce (α, β) re-fits (EWMA into "
                         "the stored sweep; 0 = off)")
    ap.add_argument("--comm-drift-threshold", type=float, default=0.25,
                    help="relative (α, β) drift that triggers a comm re-plan")
    ap.add_argument("--replan-every", type=int, default=25,
                    help="steps between measured-profile drift checks (0 = off)")
    ap.add_argument("--replan-threshold", type=float, default=0.25,
                    help="relative per-unit backward-time drift that triggers a re-plan")
    ap.add_argument("--issue-order", default="post", choices=["post", "dag"],
                    help="reduce after backward (post) or issue each group's all-reduce "
                         "when its last gradient lands (dag)")
    ap.add_argument("--dryrun", type=int, default=0, metavar="N",
                    help="trace-first smoke: run N steps with the span recorder, print "
                         "the measured overlap report (comm hidden under backward, from "
                         "the wfbp_group*/bwd_* spans), and stop")
    ap.add_argument("--trace-out", default=None,
                    help="with --dryrun: write the Chrome-trace JSON here (.gz for gzip)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_ckpt"),
                    help="checkpoint directory; a restart restores its latest step, so give "
                         "each run its own")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (full-width TinyLlama-1.1B under AdamW "
                         "with bf16_ef writes ~15 GB per checkpoint)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="failures the run survives before it raises")
    ap.add_argument("--plan-in", default=None, help="load a serialized Plan instead of planning")
    ap.add_argument("--plan-out", default=None, help="write the Plan JSON here")
    ap.add_argument("--attn-impl", default="flash", choices=["flash", "plain"],
                    help="attention: the flash-attention kernels (flash) or the plain "
                         "einsum/softmax path (plain)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises when CUDA is missing) or cpu")
    return ap


@dataclasses.dataclass
class TrainResult:
    """What one run did, for callers that drive ``run`` directly."""

    engine: MGWFBPEngine  # the engine in effect at the end; ``.plan`` is the adopted plan
    model: Transformer
    losses: list[float]  # one per step index: its first run
    step_seconds: list[float]
    tokens_per_step: int  # global
    peak_memory_bytes: int | None  # CUDA only
    comm_model: AllReduceModel | None = None  # (α, β) the run started with
    tuner_history: list[SweepRecord] = dataclasses.field(default_factory=list)
    unit_profiles: list[UnitProfile] = dataclasses.field(default_factory=list)  # probe passes
    #: the rest is one entry per step run, replays after a restart included:
    #: its step index, plan groups, and the kernel launches
    #: (``kernels.launch_counts``) and ``issue()`` calls (key ``issue``) it
    #: made, nonzero ones only; ``step_seconds`` too
    step_indices: list[int] = dataclasses.field(default_factory=list)
    step_groups: list[int] = dataclasses.field(default_factory=list)
    step_launches: list[dict[str, int]] = dataclasses.field(default_factory=list)
    replayed_losses: list[tuple[int, float]] = dataclasses.field(default_factory=list)
    restarts: int = 0
    checkpoint_steps: list[int] = dataclasses.field(default_factory=list)  # saved, in order
    #: ``AsyncCheckpointer.records``: bytes and seconds of each save and restore
    checkpoint_records: list[dict] = dataclasses.field(default_factory=list)
    straggler_remediations: int = 0
    state: RunState | None = None  # the final state (live tensors)
    report: dict | None = None  # --dryrun: the overlap report of the recorded steps

    @property
    def plan(self) -> Plan:
        return self.engine.plan


@dataclasses.dataclass
class TrainSetup:
    """Everything a run sets up before its first step (``prepare``);
    ``close()`` removes the step's hooks and the process group it made."""

    args: argparse.Namespace
    cfg: ArchConfig
    engine: MGWFBPEngine
    model: Transformer
    optimizer: Optimizer
    step_fn: TrainStep
    data: SyntheticLMStream
    device: torch.device
    rank: int
    world: int
    pg: ProcessWorld
    comm_obs: MeasuredComm  # timed (--measure-comm) or the preset sampled on the sweep

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        return batch_to_device(self.data.batch_at(step), self.device)

    def adopt(self, engine: MGWFBPEngine, recorder=None) -> None:
        """Train on with ``engine``'s plan: a new step that takes over the
        optimizer state and residual of the current one, whose hooks are
        removed."""
        old = self.step_fn
        old.close()
        self.step_fn = engine.make_train_step(
            self.model, self.optimizer, lr=self.args.lr, issue=self.args.issue_order,
            residual=old.residual, opt_state=old.opt_state, recorder=recorder,
        )
        self.engine = engine

    def close(self) -> None:
        self.step_fn.close()
        self.pg.close()


def prepare(argv: list[str] | None = None, *, quiet: bool = False,
            overrides: dict | None = None) -> TrainSetup:
    """Parse ``argv`` like the command line and set up the run: device,
    process group, (α, β) model, plan, model (weights from seed 0),
    optimizer, data.  ``overrides`` replaces fields of the arch config
    (``{'n_layers': 8}``), as the config registry's keyword overrides do."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.plan_in and args.autotune:
        ap.error("--plan-in and --autotune are mutually exclusive: the tuner's sweep "
                 "picks the plan (drop --autotune to pin a serialized plan)")
    say = (lambda *a: None) if quiet else print

    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)

    cfg = (get_reduced if args.reduced else get_config)(args.arch, **(overrides or {}))
    if args.reduced:
        cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)

    compression = args.compression
    if compression is None and args.comm_dtype == "bf16":
        compression = "bf16"
    if compression == "bf16_ef" and args.fuse != "arena":
        ap.error("--compression bf16_ef requires --fuse arena")
    sync_cfg = SyncConfig(
        comm_dtype=torch.bfloat16 if args.comm_dtype == "bf16" else torch.float32,
        compression=compression,
        fuse=args.fuse,
    )

    pg = ProcessWorld(device)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        if args.measure_comm:
            comm_obs = MeasuredComm.time_psums(None, ("data",), device=device)
            ar_model = MeasuredFabric.from_comm(comm_obs).cost("all_reduce", {"data": world})
            say(f"[train] measured comm fit: α={ar_model.a:.3e}s β={ar_model.b:.3e}s/B")
        else:
            ar_model = get_fabric(args.fabric).cost("all_reduce", {"data": args.virtual_dp})
            # the analytic prior sampled on the standard sweep, so the online
            # EWMA re-fit has observations to blend fresh probes into
            comm_obs = MeasuredComm(
                sizes_bytes=DEFAULT_COMM_SWEEP,
                times_s=tuple(ar_model(s) for s in DEFAULT_COMM_SWEEP),
                name="analytic_prior",
            )
        plan_in = Plan.load(args.plan_in) if args.plan_in else None
        eng = MGWFBPEngine.build(
            cfg, param_shapes(cfg),
            ar_model=ar_model,
            tokens_per_device=args.batch * args.seq // world,
            policy=args.policy if plan_in is not None else (args.policy or "mg_wfbp"),
            sync_config=sync_cfg,
            plan=plan_in,
        )
        say(f"[train] {eng.plan.describe()}")
        say(f"[train] device {device}, world {world}, {eng.sync.n_groups} groups, "
            f"fuse={sync_cfg.fuse} wire={sync_cfg.wire_dtype} issue={args.issue_order} "
            f"attn={cfg.attn_impl if cfg.attention is not None else 'none'}")
        model = Transformer(cfg, device=device, seed=0)
        data = make_stream(
            DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                       input_mode=cfg.input_mode, d_model=cfg.d_model),
            host_rank=rank, host_count=world,
        )
        optimizer = make_optimizer(args.optimizer)
        step_fn = eng.make_train_step(model, optimizer, lr=args.lr, issue=args.issue_order)
    except BaseException:
        pg.close()
        raise
    return TrainSetup(args=args, cfg=cfg, engine=eng, model=model, optimizer=optimizer,
                      step_fn=step_fn, data=data, device=device, rank=rank, world=world,
                      pg=pg, comm_obs=comm_obs)


def _counts() -> dict[str, int]:
    out = launch_counts()
    out["issue"] = issue.calls
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dryrun(setup: TrainSetup, say) -> tuple[dict, list[float]]:
    """Trace-first smoke: run ``--dryrun`` steps under a span recorder and
    report how much of the wire the issue order actually hides under
    backward — measured from the recorded spans, not the model.  The
    first step's spans are dropped (warm-up)."""
    args, device = setup.args, setup.device
    rec = TraceRecorder(cuda=device.type == "cuda")
    setup.adopt(setup.engine, recorder=rec)
    batch = setup.batch(0)
    losses = [float(setup.step_fn(batch)["loss"])]
    _sync(device)
    if args.dryrun > 1:
        rec.clear()
        for _ in range(args.dryrun - 1):
            losses.append(float(setup.step_fn(batch)["loss"]))
        _sync(device)
    report = overlap_report(rec.spans())
    sched = setup.engine.plan.schedule
    say(f"[dryrun] issue={args.issue_order} loss={losses[-1]:.4f} groups={list(sched.groups)}")
    say(f"[dryrun] overlap fraction {report['overlap_fraction']:.3f} "
        f"({report['windowed_comm_us']:.0f}us of {report['total_comm_us']:.0f}us "
        f"comm inside the backward window; strict concurrent overlap "
        f"{report['hidden_fraction']:.3f}; {report['n_overlapped_starts']}/"
        f"{report['n_comm_spans']} comm spans start inside backward)")
    say("[dryrun] " + json.dumps(
        {k: report[k] for k in ("n_devices", "n_comm_spans", "n_bwd_spans",
                                "total_comm_us", "windowed_comm_us",
                                "hidden_comm_us", "overlap_fraction",
                                "hidden_fraction", "n_overlapped_starts")}
    ))
    if args.trace_out and setup.rank == 0:
        rec.save(args.trace_out)
        say(f"[dryrun] trace written to {args.trace_out}")
    return report, losses


def run(argv: list[str] | None = None, *, quiet: bool = False,
        overrides: dict | None = None,
        measure_units: Callable[[], dict[str, float]] | None = None,
        fault_injector: Callable[[int], None] | None = None) -> TrainResult:
    """Parse ``argv`` like the command line and train; returns the run:
    the plan in effect at the end, the tuner's history, the probe passes,
    the per-step launches, the restarts and checkpoints, the final state
    and, under ``--dryrun``, the overlap report.  ``overrides`` as for
    ``prepare``.  ``measure_units`` stands in for the probe pass under
    ``--autotune`` (unit name -> backward seconds; its values are still
    taken from rank 0).  ``fault_injector(step)`` is called before each
    step and may raise to simulate a failure (``resilient_loop``)."""
    say = (lambda *a: None) if quiet else print
    setup = prepare(argv, quiet=quiet, overrides=overrides)
    args, device, cfg = setup.args, setup.device, setup.cfg
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        timer = StepTimer(window=max(8, args.replan_every or 8))
        profiles: list[UnitProfile] = []
        tuner: Tuner | None = None
        probes = probe_batch = None
        start_engine = setup.engine  # the analytic (or --plan-in) plan
        if args.autotune:
            tuner = Tuner(
                layout=setup.engine.plan.layout,
                n_scan_stages=cfg.n_stages,
                shapes=param_shapes(cfg),
                wire_dtype=dtype_name(setup.engine.sync_config.wire_dtype),
                provenance={"arch": cfg.name},
            )
            if measure_units is None:
                # copies of the unit parameters, made once, only when probing
                probe_batch = setup.batch(0)
                probes = make_unit_probes(cfg, setup.model, probe_batch)
        refitter = psum_time = None
        if args.comm_refit_every:
            refitter = CommRefitter(base=setup.comm_obs, threshold=args.comm_drift_threshold)
            psum_time = psum_time_fn(None, device=device)

        def measured_unit_costs() -> MeasuredCosts:
            """Per-unit probe times -> measured cost vector (non-uniform
            drift, unlike the whole-step rescale), rank 0's on every rank."""
            eng = setup.engine
            if measure_units is not None:
                seconds = measure_units()
            else:
                seconds = probe_unit_times(cfg, setup.model, probe_batch, eng.plan.layout,
                                           probes=probes).unit_seconds
            names = sorted(seconds)
            profile = UnitProfile(dict(zip(names, rank0_values([seconds[n] for n in names],
                                                               device=device))))
            profiles.append(profile)
            return MeasuredCosts.from_segment_times(
                list(eng.plan.costs), eng.plan.hw, profile.unit_seconds,
                name="probe_segments",
            )

        def adopt_plan(plan: Plan, why: str) -> None:
            setup.adopt(setup.engine.with_plan(plan))
            timer.reset()
            say(f"[train] {why} -> {setup.engine.plan.describe()}")

        def tuner_sweep(costs: MeasuredCosts, model, comm_source: str, trigger: str) -> Plan:
            return tuner.sweep(
                costs.layer_costs(), model, costs.hw,
                cost_source=costs.name, comm_source=comm_source, trigger=trigger,
            )

        if tuner is not None:
            plan = tuner_sweep(measured_unit_costs(), setup.engine.plan.ar_model,
                               "measured" if args.measure_comm else "analytic", "startup")
            adopt_plan(plan, "autotune startup sweep "
                             f"({tuner.last_record.chosen}, "
                             f"{len(tuner.last_record.candidates)} candidates)")

        def maybe_replan(step: int) -> None:
            """Measured-profile drift check (journal MG-WFBP online re-plan)."""
            eng = setup.engine
            modeled = eng.plan.schedule.result
            if modeled is None or timer.median() is None or len(timer) < 5:
                return
            measured_t = rank0_values([timer.median()], device=device)[0]
            if tuner is not None:
                tuner.observe(measured_t)
                measured = measured_unit_costs()
                drift = cost_drift(eng.plan, measured)
                if drift > args.replan_threshold:
                    plan = tuner_sweep(
                        measured, eng.plan.ar_model,
                        eng.plan.provenance.get("comm_source", "analytic"), "cost_drift",
                    )
                    adopt_plan(plan, f"step {step}: cost drift {drift:.3f} re-sweep")
                return
            measured = MeasuredCosts.from_step_timing(
                list(eng.plan.costs), eng.plan.hw, measured_t, modeled.t_iter
            )
            new_eng, replanned = eng.replan(measured, threshold=args.replan_threshold)
            if replanned:
                setup.adopt(new_eng)
                timer.reset()
                say(f"[train] step {step}: re-planned "
                    f"(drift {new_eng.plan.provenance['drift']}) -> "
                    f"{new_eng.plan.schedule.describe()}")

        def maybe_refit_comm(step: int) -> None:
            """Amortized comm-side drift check: slim all-reduce sweep ->
            EWMA -> (α, β) re-fit -> re-plan past the threshold."""
            fit, drift, drifted = refitter.check(psum_time)
            if not drifted:
                return
            eng = setup.engine
            if tuner is not None:
                plan = tuner_sweep(
                    MeasuredCosts(costs=tuple(eng.plan.costs), hw=eng.plan.hw,
                                  name=eng.plan.provenance.get("cost_source", "analytic")),
                    fit, "measured_comm_refit", "comm_drift",
                )
                adopt_plan(plan, f"step {step}: comm drift {drift:.3f} "
                                 f"(α={fit.a:.3e} β={fit.b:.3e}) re-sweep")
            else:
                new_plan, replanned = refitter.replan(eng.plan, fit)
                if replanned:
                    adopt_plan(new_plan, f"step {step}: comm drift {drift:.3f} re-plan")

        result = TrainResult(
            engine=setup.engine, model=setup.model, losses=[], step_seconds=[],
            tokens_per_step=args.batch * args.seq, peak_memory_bytes=None,
            comm_model=setup.engine.plan.ar_model, tuner_history=[], unit_profiles=profiles,
        )
        if args.dryrun:
            result.report, result.losses = _dryrun(setup, say)
        else:
            def live_state(step: int, restarts: int) -> RunState:
                fn = setup.step_fn
                return RunState(step=step, params=fn.params, opt_state=fn.opt_state,
                                restarts=restarts, residual=fn.residual)

            def init_state() -> RunState:
                """Step 0's state, written into the live tensors: the weights
                drawn from seed 0 again, the optimizer state (zeros at init,
                for both optimizers) and the residual zeroed."""
                fn = setup.step_fn
                with torch.no_grad():
                    setup.model.reset_parameters(0)
                    for t in (*fn.opt_state.m.values(), *fn.opt_state.v.values(),
                              *(fn.residual or {}).values()):
                        t.zero_()
                fn.opt_state.step = 0
                return live_state(0, 0)

            def do_step(state: RunState, step: int) -> RunState:
                groups = setup.engine.sync.n_groups
                batch = setup.batch(step)
                before = _counts()
                t0 = time.perf_counter()
                metrics = setup.step_fn(batch)
                loss = float(metrics["loss"])  # waits for the step
                _sync(device)
                secs = time.perf_counter() - t0
                after = _counts()
                result.step_indices.append(step)
                result.step_groups.append(groups)
                result.step_seconds.append(secs)
                result.step_launches.append(
                    {k: after[k] - before[k] for k in after if after[k] != before[k]})
                if step < len(result.losses):  # a replay after a restart
                    result.replayed_losses.append((step, loss))
                else:
                    result.losses.append(loss)
                timer.observe(secs)
                if step % 10 == 0 or step == args.steps - 1:
                    say(f"[train] step {step} loss {loss:.4f} ({secs * 1e3:.1f} ms)")
                if args.replan_every and step and step % args.replan_every == 0:
                    maybe_replan(step)
                if refitter is not None and step and step % args.comm_refit_every == 0:
                    maybe_refit_comm(step)
                return live_state(state.step, state.restarts)

            def on_restart(state: RunState) -> RunState:
                """Same-shape restart: resume under the plan the checkpoint
                was trained with and, under --autotune, the tuner's sweep
                history and the refitter's observations; with no stored plan
                re-enter the plan search.  The step is rebuilt either way."""
                nonlocal refitter
                plan, how, engine = None, "re-planned", start_engine
                ck = agreed_latest_step(args.ckpt_dir)
                if ck is not None:
                    try:
                        plan = load_plan(args.ckpt_dir, ck)
                        if plan is not None:
                            engine = setup.engine.with_plan(plan)
                            how = "restored plan"
                    except Exception as e:  # corrupt / foreign / mismatched plan -> re-plan
                        say(f"[train] stored plan unusable ({e}); re-planning")
                        plan = None
                    if tuner is not None:
                        try:
                            st = load_tuner_state(args.ckpt_dir, ck)
                            if st is not None:
                                tuner.load_state(st)
                                if st.get("comm_refitter") and refitter is not None:
                                    refitter = CommRefitter.from_state_dict(st["comm_refitter"])
                        except Exception as e:
                            say(f"[train] stored tuner state unusable ({e}); starting fresh")
                if plan is None and tuner is not None:
                    plan = tuner_sweep(measured_unit_costs(), start_engine.plan.ar_model,
                                       "measured" if args.measure_comm else "analytic",
                                       "restart")
                    engine = setup.engine.with_plan(plan)
                    how = "restart sweep"
                setup.adopt(engine)
                timer.reset()
                say(f"[train] restart at step {state.step}: {how} -> "
                    f"{setup.engine.plan.schedule.describe()}")
                return live_state(state.step, state.restarts)

            def tuner_state() -> dict:
                """Checkpointed tuner state: sweep history + the comm
                refitter's EWMA'd observations, so both online loops resume
                after a restart."""
                st = tuner.state_dict()
                if refitter is not None:
                    st["comm_refitter"] = refitter.state_dict()
                return st

            ckpt = AsyncCheckpointer(args.ckpt_dir)
            monitor = StragglerMonitor()
            final = resilient_loop(
                num_steps=args.steps,
                init_state=init_state,
                train_step=do_step,
                checkpoint_dir=args.ckpt_dir,
                checkpoint_every=args.ckpt_every,
                max_restarts=args.max_restarts,
                fault_injector=fault_injector,
                straggler=monitor,
                on_restart=on_restart,
                # every checkpoint carries the live plan and, when auto-tuning,
                # the tuner's sweep history + comm observations
                plan_provider=lambda: setup.engine.plan,
                tuner_provider=tuner_state if tuner is not None else None,
                checkpointer=ckpt,
            )
            result.state = final
            result.restarts = final.restarts
            result.checkpoint_records = ckpt.records
            result.checkpoint_steps = [r["step"] for r in ckpt.records if r["op"] == "save"]
            result.straggler_remediations = monitor.remediations
        if tuner is not None and timer.median() is not None and tuner.history:
            rec = tuner.observe(rank0_values([timer.median()], device=device)[0])
            say(f"[train] tuner: chosen={rec.chosen} "
                f"predicted_t_iter={rec.predicted_t_iter:.3e}s "
                f"observed_t_iter={rec.observed_t_iter:.3e}s "
                f"over {len(rec.candidates)} candidates")
        result.engine = setup.engine
        result.tuner_history = list(tuner.history) if tuner is not None else []
        if device.type == "cuda":
            result.peak_memory_bytes = torch.cuda.max_memory_allocated(device)
        if args.plan_out and setup.rank == 0:
            say(f"[train] plan written to {setup.engine.plan.save(args.plan_out)}")
        return result
    finally:
        setup.close()


def main() -> None:
    res = run()
    if not res.step_seconds:  # --dryrun
        return
    steady = res.step_seconds[1:] or res.step_seconds
    step_ms = statistics.median(steady) * 1e3
    print(f"[train] done: {len(res.losses)} steps, {res.restarts} restarts, final loss "
          f"{res.losses[-1]:.4f}, median step {step_ms:.1f} ms (steps after the first) "
          f"({res.tokens_per_step / step_ms * 1e3:,.0f} tokens/s), "
          f"{res.straggler_remediations} straggler remediations")


if __name__ == "__main__":
    main()
