"""Serving launcher: continuous batching through ``serving.ServingEngine``
under a fabric-priced ``ServePlan`` (counterpart of the unsharded path of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --slots 4 --requests 8 --prompt-len 32 --tokens 16 --fabric gpu_nccl

    # on the CPU, at the reduced size (f32 weights)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --reduced --device cpu --plan-out /tmp/serve_plan.json

Runs on ``cuda`` unless ``--device cpu`` is given; the weights are random,
drawn from seed 0.  The launcher builds the decode-side ``ServePlan``
(KV all-gathers for dense archs, expert all-to-alls for MoE, priced by
the ``--fabric`` preset over a ``--virtual-tp``-wide model axis), hands
it to the engine, captures the engine's step (a CUDA graph on the card),
calibrates the plan's fixed per-step term, runs the requests and prints
throughput and predicted against observed step time.  Prompts are drawn
from seed 0, ``--prompt-len`` tokens each or, with ``--prompt-lens``, the
listed lengths in turn.

Any of ``--chaos-kill-every``, ``--chaos-seed``, ``--chaos-slow-factor``,
``--chaos-slow-after``, ``--deadline-ms``, ``--snapshot-every``,
``--snapshot-dir`` and ``--max-restarts`` routes the run through
``serving.resilient_serve_loop`` (the JAX launcher's comment says so; its
code looks at four of them, and would drop the others silently): snapshots
every ``--snapshot-every`` steps (into a temporary directory unless
``--snapshot-dir``), seeded chaos, deadlines, a straggler monitor when the
fabric is slowed, and a first SIGINT that snapshots and stops cleanly.
Under kills without deadlines an uninterrupted run of the same requests on
the same weights comes first, and the ``[serve] resilience: ...`` line says
whether the resilient run's tokens match it.  From Python, ``run(argv,
chaos=ChaosConfig(...))`` gives the whole chaos schedule (``kill_at``,
``max_kills``, snapshot corruption, partial writes).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --reduced --device cpu --chaos-kill-every 3

``--sharded`` executes the plan: the engine's decode step runs on a
``("model",)`` ``DeviceMesh`` of ``min(--virtual-tp, world size)`` ranks
(``serving.sharded``: one collective per scheduled serve group), and the
plan is priced at that TP size.  ``--measure-comm`` times the real
collectives on the same mesh, fits an op-specific (α, β) into a
``MeasuredFabric`` (``'all_gather@model'``-style keys), prints the plan it
gives, times each scheduled group at its wire bytes and prints the
predicted-against-measured table.  The process group is the torchrun
world when its environment is set, else a world of one that the launcher
makes (``gloo`` on the CPU, ``nccl`` on the card) and tears down at the
end; a group the caller started is used and kept.  The mesh spans the
world, and every rank serves the same requests (mirror-compute).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --reduced --device cpu --virtual-tp 4 --sharded --measure-comm
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ARCH_NAMES, get_config, get_reduced
from ..devices import resolve_device
from ..fabric import MeasuredFabric, available_fabrics
from ..models import Transformer, param_shapes
from ..planning import (
    ServePlan,
    available_policies,
    build_serve_plan,
    group_comparison_lines,
    serve_fabric_fits,
    time_serve_groups,
)
from ..runtime import StragglerMonitor
from ..serving import (
    ChaosConfig,
    ChaosInjector,
    Request,
    ServeReport,
    ServeTimer,
    ServingEngine,
    gumbel_sampler,
    resilient_serve_loop,
)
from .mesh import ProcessWorld, make_mesh

#: The resilience flags and the values they take when another one is given
#: (the JAX launcher's defaults).
RESILIENT_DEFAULTS = {"chaos_kill_every": 0, "chaos_seed": 0, "chaos_slow_factor": 1.0,
                      "chaos_slow_after": None, "deadline_ms": None, "snapshot_every": 8,
                      "snapshot_dir": None, "max_restarts": 5}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's small variant, with f32 weights")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; nothing falls back to the CPU on its own")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch slots (continuous batching)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--prompt-lens", default=None,
                    help="comma-separated prompt lengths, taken in turn by the requests "
                         "(replaces --prompt-len)")
    ap.add_argument("--tokens", type=int, default=16, help="new tokens per request")
    ap.add_argument("--max-seq", type=int, default=None,
                    help="cache length (default: the longest prompt + --tokens + 1)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--fabric", default="tpu_v5e", choices=available_fabrics(),
                    help="interconnect preset pricing the decode collectives")
    ap.add_argument("--policy", default="mg_wfbp", choices=list(available_policies()),
                    help="scheduler policy for the serve plan")
    ap.add_argument("--virtual-tp", type=int, default=8,
                    help="TP size of the serve-plan collective model (and of the mesh "
                         "under --sharded / --measure-comm, clamped to the world size)")
    ap.add_argument("--plan-out", default=None, help="write the ServePlan JSON here")
    ap.add_argument("--sharded", action="store_true",
                    help="execute the plan: sharded decode on a TP mesh, one collective "
                         "per serve group")
    ap.add_argument("--measure-comm", action="store_true",
                    help="time the real per-group collectives, fit a MeasuredFabric, and "
                         "print predicted against measured (on --sharded's mesh)")
    # resilience: any of these routes the run through resilient_serve_loop
    for flag, kind, what in (
            ("--chaos-kill-every", int, "inject a kill every N serve steps (0 = off); the "
                                        "loop must recover token-identically"),
            ("--chaos-seed", int, "seed of the chaos fault schedule"),
            ("--chaos-slow-factor", float, "multiply observed step / collective times by this "
                                           "from --chaos-slow-after on (a degraded wire)"),
            ("--chaos-slow-after", int, "serve step after which the slowdown starts"),
            ("--deadline-ms", float, "per-request SLO: deadline = now + this; expired requests "
                                     "retire with partial output, unmeetable ones are shed"),
            ("--snapshot-every", int, "serve snapshot cadence in steps"),
            ("--snapshot-dir", str, "serve snapshot directory (a temporary one when unset)"),
            ("--max-restarts", int, "restart budget of the resilient serve loop")):
        default = RESILIENT_DEFAULTS[flag[2:].replace("-", "_")]
        ap.add_argument(flag, type=kind, default=None,
                        help=f"{what} (default when another resilience flag is given: {default})")
    return ap.parse_args(argv)


@dataclasses.dataclass
class ServeResult:
    """What a serving run gives back: the completed requests, the
    (calibrated) plan, the engine, the run's wall seconds and generated
    tokens, and the timer's prefill and decode-step samples.  A resilient
    run adds its ``ServeReport``, and under kills the uninterrupted run's
    engine (``reference``) and whether the tokens matched it."""

    completed: list[Request]
    plan: ServePlan
    engine: ServingEngine
    seconds: float
    n_tokens: int
    timer: ServeTimer
    report: ServeReport | None = None
    reference: ServingEngine | None = None
    tokens_match: bool | None = None


def _prompt_lens(args: argparse.Namespace) -> list[int]:
    if args.prompt_lens:
        return [int(x) for x in args.prompt_lens.split(",")]
    return [args.prompt_len]


def make_requests(args: argparse.Namespace, vocab: int,
                  deadline_s: float | None = None) -> list[Request]:
    """``--requests`` requests, prompts drawn from seed 0 (the JAX
    launcher's draw at a single ``--prompt-len``)."""
    rng = np.random.default_rng(0)
    lens = _prompt_lens(args)
    return [Request(rid=rid, prompt=rng.integers(0, vocab, size=lens[rid % len(lens)],
                                                 dtype=np.int32),
                    max_new_tokens=args.tokens, deadline_s=deadline_s)
            for rid in range(args.requests)]


def run(argv: list[str] | None = None, *, model: Transformer | None = None,
        cuda_graph: bool | None = None, chaos: ChaosConfig | None = None,
        quiet: bool = False) -> ServeResult:
    """Parse ``argv``, build (or take) the model, plan, engine and
    requests, and serve them to completion.  ``model`` reuses built
    weights and their config; ``cuda_graph`` is the engine's (None: a graph on the card);
    ``chaos`` replaces the schedule the ``--chaos-*`` flags would build and
    routes the run through the resilient loop."""
    args = parse_args(argv)
    resilient = chaos is not None or any(getattr(args, n) is not None
                                         for n in RESILIENT_DEFAULTS)
    for name, default in RESILIENT_DEFAULTS.items():
        if getattr(args, name) is None:
            setattr(args, name, default)
    say = (lambda msg: None) if quiet else (lambda msg: print(f"[serve] {msg}", flush=True))
    device = resolve_device(args.device)
    if not (args.sharded or args.measure_comm):
        return _serve(args, device, say, resilient, model, cuda_graph, chaos)
    world = ProcessWorld(device)
    try:
        return _serve(args, device, say, resilient, model, cuda_graph, chaos)
    finally:
        world.close()


def _tp_mesh(args: argparse.Namespace, device: torch.device, say):
    """The ``("model",)`` mesh of ``--sharded`` / ``--measure-comm`` over
    the whole world and its TP size, ``min(--virtual-tp, world size)``."""
    world = dist.get_world_size()
    tp = min(args.virtual_tp, world)
    if tp < args.virtual_tp:
        say(f"only {world} devices visible; clamping TP {args.virtual_tp} -> {tp}")
    if tp != world:
        raise ValueError(f"--virtual-tp {tp} on a world of {world} ranks: the TP mesh spans "
                         f"the world")
    return make_mesh((tp,), ("model",), device_type=device.type), tp


def _serve(args: argparse.Namespace, device: torch.device, say, resilient: bool,
           model: Transformer | None, cuda_graph: bool | None,
           chaos: ChaosConfig | None) -> ServeResult:
    if model is None:
        cfg = (get_reduced(args.arch, param_dtype=torch.float32) if args.reduced
               else get_config(args.arch))
        model = Transformer(cfg, device=device, seed=0)
    cfg = model.cfg  # a given model's own config (a depth cut, say)
    max_seq = args.max_seq or max(_prompt_lens(args)) + args.tokens + 1
    mesh, tp = None, args.virtual_tp
    if args.sharded or args.measure_comm:
        mesh, tp = _tp_mesh(args, device, say)

    # the engine's decode caches are f32, so the wire would ship 4-byte
    # elements: price the plan at what the step ships
    plan = build_serve_plan(cfg, param_shapes(cfg), args.fabric, {"model": tp},
                            batch_rows=args.slots, policy=args.policy,
                            cache_dtype_bytes=4, act_dtype_bytes=4)
    engine_mesh = mesh if args.sharded else None
    say(plan.describe())
    sample = gumbel_sampler(args.temperature) if args.temperature > 0 else None
    timer = ServeTimer()
    engine = ServingEngine(cfg, model, slots=args.slots, max_seq=max_seq, sample=sample,
                           sample_seed=2, plan=plan, mesh=engine_mesh, timer=timer,
                           cuda_graph=cuda_graph)
    engine.warmup()  # build (capture) the step before anything is timed
    if plan.schedule.result is not None:
        plan = engine.calibrate_plan()
        wire = plan.schedule.result.t_iter
        say(f"calibrated step: fixed={plan.t_step_fixed * 1e6:.1f}us + wire={wire * 1e6:.1f}us"
            f" = {(plan.t_step_fixed + wire) * 1e6:.1f}us")
    report = reference = tokens_match = None
    if resilient:
        chaos = chaos or ChaosConfig(seed=args.chaos_seed, kill_every=args.chaos_kill_every,
                                     slow_factor=args.chaos_slow_factor,
                                     slow_after=args.chaos_slow_after)
        baseline = None
        kills = chaos.kill_every > 0 or bool(chaos.kill_at) or chaos.kill_prob > 0
        if kills and args.deadline_ms is None:
            # the uninterrupted run: the chaos run must reproduce its tokens
            reference = ServingEngine(cfg, model, slots=args.slots, max_seq=max_seq,
                                      sample=sample, sample_seed=2, plan=plan,
                                      mesh=engine_mesh, cuda_graph=cuda_graph)
            for req in make_requests(args, cfg.vocab):
                reference.submit(req)
            baseline = {r.rid: r.generated for r in reference.run_to_completion()}
        straggler = (StragglerMonitor(window=16, factor=2.0, patience=2)
                     if chaos.slow_factor != 1.0 else None)
        snap_dir = args.snapshot_dir or tempfile.mkdtemp(prefix="serve_snap_")
        deadline_s = (time.monotonic() + args.deadline_ms / 1e3
                      if args.deadline_ms is not None else None)
        for req in make_requests(args, cfg.vocab, deadline_s=deadline_s):
            engine.submit(req)

        # graceful SIGINT: the first ^C snapshots and stops the loop cleanly
        stop = {"flag": False}

        def _sigint(signum, frame):
            say("SIGINT: snapshotting before exit...")
            stop["flag"] = True

        prev_handler = signal.signal(signal.SIGINT, _sigint)
        t0 = time.perf_counter()
        try:
            report = resilient_serve_loop(
                engine, snapshot_dir=snap_dir, snapshot_every=args.snapshot_every,
                max_restarts=args.max_restarts, chaos=ChaosInjector(chaos),
                straggler=straggler, stop_flag=lambda: stop["flag"])
        finally:
            signal.signal(signal.SIGINT, prev_handler)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        completed = report.completed
        rec = report.recovery_times_s
        mean_rec = sum(rec) / len(rec) if rec else 0.0
        match = ""
        if baseline is not None:
            tokens_match = {r.rid: r.generated for r in completed} == baseline
            match = f" tokens_match={tokens_match}"
        say(f"resilience: restarts={report.restarts} recovery_mean_s={mean_rec:.3f} "
            f"snapshots={report.snapshots} fallbacks={report.snapshot_fallbacks} "
            f"shed={report.shed} expired={report.expired} replans={report.replans} "
            f"interrupted={report.interrupted} goodput_tok_s={report.goodput_tok_per_s:.1f}"
            f"{match} (snapshots in {snap_dir})")
    else:
        for req in make_requests(args, cfg.vocab):
            engine.submit(req)
        t0 = time.perf_counter()
        completed = engine.run_to_completion()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    n_tok = sum(len(r.generated) for r in completed)
    step = "CUDA graph" if engine.cuda_graph else "eager step"
    mode = f"sharded TP={tp}" if args.sharded else "unsharded"
    say(f"{len(completed)} requests, {n_tok} tokens in {dt:.2f}s "
        f"({n_tok / max(dt, 1e-9):.1f} tok/s, {args.slots} slots, {mode}, {step} on {device})")
    predicted, observed = engine.predicted_step_time(), engine.observed_step_time()
    if predicted is not None:
        say(f"plan predicted step: {predicted * 1e3:.3f}ms "
            f"({plan.op} over {plan.axis_sizes} on {plan.fabric})")
    if observed is not None:
        say(f"observed step: {observed * 1e3:.3f}ms"
            + (f" (observed/predicted = {observed / predicted:.1f}x)" if predicted else ""))
    if args.measure_comm:
        fits = serve_fabric_fits(mesh, ops=(plan.op,), axes=("model",))
        fab = MeasuredFabric(models=fits, name="measured_serve")
        for key, fit in fits.items():
            say(f"measured fit {key}: a={fit.a:.3e}s b={fit.b:.3e}s/B")
        measured_plan = build_serve_plan(cfg, param_shapes(cfg), fab, {"model": tp},
                                         batch_rows=args.slots, policy=args.policy, op=plan.op,
                                         cache_dtype_bytes=4, act_dtype_bytes=4)
        say(f"measured-fabric plan: {measured_plan.describe()}")
        timer.group_times = time_serve_groups(plan, mesh)
        say("per-group predicted vs measured:")
        for line in group_comparison_lines(plan, timer.group_times):
            say("  " + line)
    if args.plan_out:
        say(f"serve plan written to {plan.save(args.plan_out)}")
    return ServeResult(completed=completed, plan=plan, engine=engine, seconds=dt,
                       n_tokens=n_tok, timer=timer, report=report, reference=reference,
                       tokens_match=tokens_match)


def main() -> None:
    run()


if __name__ == "__main__":
    main()
