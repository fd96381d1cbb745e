"""Fleet launcher: N health-checked serving replicas behind the SLO-aware
router, under seeded chaos and seeded load (counterpart of
``repro/launch/serve_fleet.py``, with the same flags and ``[fleet]`` lines).

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet --arch tinyllama-1.1b \\
        --replicas 4 --requests 32 --rate 200 \\
        --chaos-kill-at 3 --chaos-replicas 0 --deadline-ms 2000

    # on the CPU, at the reduced size (f32 weights)
    PYTHONPATH=src python -m repro_torch.launch.serve_fleet --arch tinyllama-1.1b \\
        --reduced --device cpu --chaos-kill-at 2 --chaos-replicas 0

One process, N ``ServingEngine`` replicas sharing one model (one copy of
the weights; each replica its own caches and, on the card, its own CUDA
graph), one ``FleetController`` (``serving.fleet``): a seeded Poisson or
trace ``LoadGenerator`` offers the traffic, the router places each request
on the replica with the cheapest plan-priced ETA (shedding it when no
replica meets its deadline), each replica's ``ChaosInjector`` is derived
from one fleet seed, and a replica that spends its restore budget fails its
requests over to live peers with their partial output.  ``--elastic`` lets
the plan-priced watchdog add and retire replicas.  Runs on ``cuda`` unless
``--device cpu``; the weights are random, drawn from seed 0.
``failover_token_mismatches`` must be 0: the run exits non-zero otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from typing import Callable

import torch

from ..configs import ARCH_NAMES, get_config, get_reduced
from ..devices import resolve_device
from ..fabric import available_fabrics
from ..models import Transformer, param_shapes
from ..planning import available_policies, build_serve_plan
from ..serving import (
    ChaosConfig,
    FleetConfig,
    FleetController,
    FleetReport,
    LoadGenerator,
    LoadSpec,
    ServingEngine,
)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve_fleet")
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's small variant, with f32 weights")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; nothing falls back to the CPU on its own")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4, help="decode batch slots per replica")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=None,
                    help="cache length (default: --prompt-len + --tokens + 1)")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson offered load, requests/second")
    ap.add_argument("--trace", default=None,
                    help="comma-separated arrival offsets (seconds); overrides --rate "
                         "with a trace schedule")
    ap.add_argument("--load-seed", type=int, default=0,
                    help="seed of arrivals and prompts (one seed replays the whole load)")
    ap.add_argument("--fabric", default="gpu_nccl", choices=list(available_fabrics()))
    ap.add_argument("--policy", default="mg_wfbp", choices=list(available_policies()))
    ap.add_argument("--virtual-tp", type=int, default=8,
                    help="TP size the serve plan prices collectives at")
    # SLO
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request SLO relative to its arrival; requests no replica "
                         "can finish in time are shed at admission")
    # chaos
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="ONE fleet seed; each replica's fault domain is derived from it "
                         "(ChaosConfig.for_replica)")
    ap.add_argument("--chaos-kill-at", type=int, default=None,
                    help="kill each chaos replica at this local serve step")
    ap.add_argument("--chaos-kill-every", type=int, default=0)
    ap.add_argument("--chaos-slow-factor", type=float, default=1.0)
    ap.add_argument("--chaos-slow-after", type=int, default=None)
    ap.add_argument("--chaos-replicas", default=None,
                    help="comma-separated replica ids the chaos schedule applies to "
                         "(default: all)")
    # fleet knobs
    ap.add_argument("--max-restores", type=int, default=1,
                    help="per-replica in-place restore budget; past it the replica dies "
                         "and its requests fail over")
    ap.add_argument("--snapshot-every", type=int, default=8)
    ap.add_argument("--snapshot-root", default=None,
                    help="root of the per-replica snapshot directories (a temporary one "
                         "when unset)")
    ap.add_argument("--heartbeat-timeout-s", type=float, default=None)
    ap.add_argument("--elastic", action="store_true",
                    help="apply the watchdog's scale decisions (else they are recorded only)")
    ap.add_argument("--max-replicas", type=int, default=8)
    ap.add_argument("--scale-up-backlog-s", type=float, default=float("inf"),
                    help="scale up when the plan-priced backlog drain time exceeds this")
    ap.add_argument("--scale-down-idle-rounds", type=int, default=0)
    return ap.parse_args(argv)


@dataclasses.dataclass
class FleetResult:
    """What a fleet run gives back: the report and the controller (its
    replicas' engines and drivers)."""

    report: FleetReport
    fleet: FleetController


def run(argv: list[str] | None = None, *, model: Transformer | None = None,
        clock: Callable[[], float] | None = None, quiet: bool = False) -> FleetResult:
    """Parse ``argv``, build (or take) the shared model, the plan and the
    fleet, and serve the seeded load.  ``clock`` replaces the fleet's
    ``time.monotonic`` (a deterministic clock makes a chaos run repeat).
    Raises ``SystemExit`` on a failover token mismatch."""
    args = parse_args(argv)
    say = (lambda msg: None) if quiet else (lambda msg: print(f"[fleet] {msg}", flush=True))
    device = resolve_device(args.device)
    cfg = (get_reduced(args.arch, param_dtype=torch.float32) if args.reduced
           else get_config(args.arch))
    if model is None:
        model = Transformer(cfg, device=device, seed=0)
    max_seq = args.max_seq or args.prompt_len + args.tokens + 1

    # the engines' decode caches are f32: price the plan at what the step ships
    plan = build_serve_plan(cfg, param_shapes(cfg), args.fabric, {"model": args.virtual_tp},
                            batch_rows=args.slots, policy=args.policy,
                            cache_dtype_bytes=4, act_dtype_bytes=4)
    say(plan.describe())

    def engine_factory(rid: int) -> ServingEngine:
        eng = ServingEngine(cfg, model, slots=args.slots, max_seq=max_seq, plan=plan)
        eng.warmup()
        return eng

    chaos = None
    if (args.chaos_kill_at is not None or args.chaos_kill_every > 0
            or args.chaos_slow_factor != 1.0):
        chaos = ChaosConfig(
            seed=args.chaos_seed,
            kill_at=(args.chaos_kill_at,) if args.chaos_kill_at is not None else (),
            kill_every=args.chaos_kill_every,
            slow_factor=args.chaos_slow_factor,
            slow_after=args.chaos_slow_after,
        )
    chaos_replicas = (tuple(int(x) for x in args.chaos_replicas.split(","))
                      if args.chaos_replicas is not None else None)
    spec = LoadSpec(
        n_requests=args.requests,
        prompt_len=args.prompt_len,
        max_new_tokens=args.tokens,
        kind="trace" if args.trace else "poisson",
        rate_rps=args.rate,
        trace_arrivals_s=tuple(float(x) for x in args.trace.split(",")) if args.trace else (),
        deadline_s=args.deadline_ms / 1e3 if args.deadline_ms is not None else None,
        seed=args.load_seed,
        vocab=cfg.vocab,
    )
    snap_root = args.snapshot_root or tempfile.mkdtemp(prefix="serve_fleet_")
    fleet = FleetController(
        engine_factory=engine_factory,
        config=FleetConfig(
            replicas=args.replicas,
            snapshot_every=args.snapshot_every,
            max_restores=args.max_restores,
            heartbeat_timeout_s=args.heartbeat_timeout_s,
            elastic=args.elastic,
            max_replicas=args.max_replicas,
            scale_up_backlog_s=args.scale_up_backlog_s,
            scale_down_idle_rounds=args.scale_down_idle_rounds,
        ),
        snapshot_root=snap_root,
        clock=clock or time.monotonic,
        chaos=chaos,
        chaos_replicas=chaos_replicas,
    )
    load = "trace" if args.trace else f"poisson {args.rate:.0f} rps"
    say(f"{args.replicas} replicas x {args.slots} slots, {args.requests} requests ({load}), "
        f"chaos={'on' if chaos else 'off'} (snapshots in {snap_root})")

    report = fleet.run(LoadGenerator(spec))
    s = report.summary()
    say(f"offered={s['offered']} completed={s['completed']} shed={s['shed']} "
        f"expired={s['expired']} rounds={s['rounds']}")
    say(f"p50={s['p50_latency_s'] * 1e3:.1f}ms p99={s['p99_latency_s'] * 1e3:.1f}ms "
        f"goodput={s['goodput_tok_per_s']:.1f} tok/s "
        f"({s['goodput_tokens']} tokens in {s['wall_s']:.2f}s)")
    say(f"deaths={s['replica_deaths']} failovers={s['failovers']} restores={s['restores']} "
        f"replans={s['replans']} scale_ups={s['scale_ups']} scale_downs={s['scale_downs']} "
        f"token_mismatches={s['failover_token_mismatches']}")
    for rep in report.replicas:
        say(f"  replica {rep['rid']}: steps={rep['steps']} restarts={rep['restarts']} "
            f"replans={rep['replans']} failed_over={rep['failed_over']} "
            f"retired={rep['retired']}")
    if report.failover_token_mismatches:
        raise SystemExit("[fleet] FAILOVER TOKEN MISMATCH: partial prefixes were not preserved")
    return FleetResult(report=report, fleet=fleet)


def main() -> None:
    run()


if __name__ == "__main__":
    main()
