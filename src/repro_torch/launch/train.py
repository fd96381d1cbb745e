"""Training launcher: the MG-WFBP engine + the synthetic data pipeline
(counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 20 --fuse arena --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given.  Under ``torchrun``
the process group comes from its environment (one rank per process,
``nccl`` on CUDA, ``gloo`` on the CPU); otherwise the launcher makes a
world of one on a local ``FileStore``.  The tuner, re-planning,
checkpoints and the fault-tolerant loop are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import statistics
import tempfile
import time

import torch
import torch.distributed as dist

from ..configs import ARCH_NAMES, get_config, get_reduced
from ..core.sync import SyncConfig
from ..core.trainer import MGWFBPEngine, TrainStep, batch_to_device
from ..data import DataConfig, SyntheticLMStream, make_stream
from ..devices import resolve_device
from ..fabric import available_fabrics, get_fabric
from ..models.transformer import Transformer, param_shapes
from ..optim import make_optimizer
from ..planning import Plan, available_policies


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
                         "match the plan's policy")
    ap.add_argument("--comm-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--compression", default=None, choices=["bf16", "bf16_ef"],
                    help="wire compression (default: follows --comm-dtype); bf16_ef "
                         "carries the error-feedback residual (requires --fuse arena)")
    ap.add_argument("--fuse", default="concat", choices=["concat", "arena"],
                    help="wire layout: concat (one flat buffer, copy each way) or arena "
                         "(the comm_pack pack/unpack kernels)")
    ap.add_argument("--virtual-dp", type=int, default=32,
                    help="DP size assumed by the α–β schedule model")
    ap.add_argument("--fabric", default="tpu_v5e", choices=available_fabrics(),
                    help="interconnect preset pricing the DP all-reduce")
    ap.add_argument("--issue-order", default="post", choices=["post", "dag"],
                    help="reduce after backward (post) or issue each group's all-reduce "
                         "when its last gradient lands (dag)")
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

    engine: MGWFBPEngine
    model: Transformer
    losses: list[float]
    step_seconds: list[float]
    tokens_per_step: int  # global
    peak_memory_bytes: int | None  # CUDA only


class _ProcessGroup:
    """Joins the torchrun world when its environment is set, else makes a
    world of one on a ``FileStore`` in a temporary directory; tears down
    only what it made."""

    def __init__(self, device: torch.device):
        self.made = False
        self.tmp = None
        if dist.is_initialized():
            return
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            self.tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
            store = dist.FileStore(os.path.join(self.tmp, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
        self.made = True

    def close(self) -> None:
        if self.made:
            dist.destroy_process_group()
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)


@dataclasses.dataclass
class TrainSetup:
    """Everything a run sets up before its first step (``prepare``);
    ``close()`` removes the step's hooks and the process group it made."""

    args: argparse.Namespace
    engine: MGWFBPEngine
    model: Transformer
    step_fn: TrainStep
    data: SyntheticLMStream
    device: torch.device
    rank: int
    world: int
    pg: _ProcessGroup

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        return batch_to_device(self.data.batch_at(step), self.device)

    def close(self) -> None:
        self.step_fn.close()
        self.pg.close()


def prepare(argv: list[str] | None = None, *, quiet: bool = False,
            overrides: dict | None = None) -> TrainSetup:
    """Parse ``argv`` like the command line and set up the run: device,
    process group, plan, model (weights from seed 0), optimizer, data.
    ``overrides`` replaces fields of the arch config (``{'n_layers': 8}``),
    as the config registry's keyword overrides do."""
    ap = build_parser()
    args = ap.parse_args(argv)
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

    pg = _ProcessGroup(device)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        ar_model = get_fabric(args.fabric).cost("all_reduce", {"data": args.virtual_dp})
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
            DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
            host_rank=rank, host_count=world,
        )
        step_fn = eng.make_train_step(
            model, make_optimizer(args.optimizer), lr=args.lr, issue=args.issue_order
        )
    except BaseException:
        pg.close()
        raise
    return TrainSetup(args=args, engine=eng, model=model, step_fn=step_fn, data=data,
                   device=device, rank=rank, world=world, pg=pg)


def run(argv: list[str] | None = None, *, quiet: bool = False,
        overrides: dict | None = None) -> TrainResult:
    """Parse ``argv`` like the command line and train; returns the run.
    ``overrides`` as for ``prepare``."""
    say = (lambda *a: None) if quiet else print
    setup = prepare(argv, quiet=quiet, overrides=overrides)
    args, device = setup.args, setup.device
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        losses, times = [], []
        for step in range(args.steps):
            batch = setup.batch(step)
            t0 = time.perf_counter()
            metrics = setup.step_fn(batch)
            loss = float(metrics["loss"])  # waits for the step
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            if step % 10 == 0 or step == args.steps - 1:
                say(f"[train] step {step} loss {loss:.4f} ({times[-1] * 1e3:.1f} ms)")
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        if args.plan_out and setup.rank == 0:
            say(f"[train] plan written to {setup.engine.plan.save(args.plan_out)}")
        return TrainResult(
            engine=setup.engine, model=setup.model, losses=losses, step_seconds=times,
            tokens_per_step=args.batch * args.seq, peak_memory_bytes=peak,
        )
    finally:
        setup.close()


def main() -> None:
    res = run()
    steady = res.step_seconds[1:] or res.step_seconds
    step_ms = statistics.median(steady) * 1e3
    print(f"[train] done: {len(res.losses)} steps, final loss {res.losses[-1]:.4f}, "
          f"median step {step_ms:.1f} ms (steps after the first) "
          f"({res.tokens_per_step / step_ms * 1e3:,.0f} tokens/s)")


if __name__ == "__main__":
    main()
