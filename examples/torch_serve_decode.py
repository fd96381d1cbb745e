"""Serving example (the PyTorch port): fabric-priced decode plans,
continuous batching, and the plan executed: the same prompts decoded
sharded and unsharded.

It builds the decode-side ``ServePlan`` for two interconnect presets on
one arch at full scale and prints how the fabric moves the merge set (the
TPU's microsecond startup keeps per-stage KV all-gathers apart, while an
NCCL-class launch overhead merges them: Eq. 10, the merge gain is α), then
runs one request batch through ``serving.ServingEngine`` twice on the
reduced arch: unsharded, and sharded over a ``("model",)`` TP mesh where
every scheduled serve group issues one collective.  The tokens must match.
The closing table leads with the calibrated fixed-against-wire step
decomposition and sets each group's predicted collective time beside one
measured on the mesh (``planning.time_serve_groups``).

The TP mesh spans the process group the example runs in: one rank alone
(one card, or one gloo rank with ``--device cpu``), or every rank under
``torchrun``.  The JAX example makes 4 virtual devices in one process; a
PyTorch process has no such devices, so alone it shards at TP 1, where
each group's collective runs on a world of one.

    python examples/torch_serve_decode.py --arch tinyllama-1.1b \\
        --fabric gpu_nccl --tokens 12 [--device cpu]
"""

import argparse
import dataclasses
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.launch.mesh import ProcessWorld, make_mesh
from repro_torch.models import Transformer, param_shapes
from repro_torch.planning import build_serve_plan, group_comparison_lines, time_serve_groups
from repro_torch.serving import Request, ServeTimer, ServingEngine


def main(argv=None):
    """Run both engines; returns ``{'unsharded', 'sharded'}`` (each
    ``{rid: tokens}``), ``'match'`` and ``'tp'``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_NAMES)
    ap.add_argument("--fabric", default="tpu_v5e",
                    help="fabric preset the engine's plan is priced on")
    ap.add_argument("--compare", default="gpu_nccl",
                    help="second preset for the plan-difference table")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds params, prompts, and the engine's sampling "
                         "key — the whole demo is reproducible per seed")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; nothing falls back to the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # Plan differences are shown at the FULL arch scale (per-stage decode
    # compute large enough that fabric startup moves the merge set); the
    # engine then runs the reduced config
    full_cfg = get_config(args.arch)
    full_shapes = param_shapes(full_cfg)
    print(f"== decode plans, {args.arch} @ 16 rows, TP=8 ==")
    plans = {}
    for preset in dict.fromkeys((args.fabric, args.compare, "tpu_v5e")):
        plan = build_serve_plan(full_cfg, full_shapes, preset, {"model": 8},
                                batch_rows=16)
        plans[preset] = plan
        r = plan.schedule.result
        print(f"  {preset:12s} α={plan.model.a:.2e}s  "
              f"{len(plan.schedule.groups):2d} groups  "
              f"t_step={r.t_iter * 1e6:7.1f}µs  "
              f"exposed_comm={r.t_comm_exposed * 1e6:6.1f}µs  ({plan.op})")
    a, b = args.fabric, args.compare
    if len(plans[a].schedule.groups) != len(plans[b].schedule.groups):
        print(f"  -> {a} and {b} pick different merge sets from the SAME "
              f"cost vector: only the fabric's (α, β) moved.")

    cfg = dataclasses.replace(get_reduced(args.arch), param_dtype=torch.float32)
    world = ProcessWorld(device)
    try:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        model = Transformer(cfg, device=device, seed=args.seed)
        tp = torch.distributed.get_world_size()
        mesh = make_mesh((tp,), ("model",), device_type=device.type)
        # the engine runs f32 caches: price the wire at 4 bytes an element
        # so the measured group collectives ship exactly the predicted bytes
        plan = build_serve_plan(cfg, param_shapes(cfg), args.fabric, {"model": tp},
                                batch_rows=args.slots,
                                cache_dtype_bytes=4, act_dtype_bytes=4)

        def run(mesh_arg):
            engine = ServingEngine(
                cfg, model, slots=args.slots,
                max_seq=args.prompt_len + args.tokens + 1, plan=plan,
                sample_seed=args.seed, mesh=mesh_arg,
                timer=ServeTimer(skip_first=1),
            )
            # build (on the card: capture) and probe before the timed loop: the
            # printed tok/s and step times are steady-state steps
            engine.warmup()
            engine.calibrate_plan()
            rng = np.random.default_rng(args.seed)
            for rid in range(args.requests):
                engine.submit(Request(
                    rid=rid,
                    prompt=rng.integers(0, cfg.vocab, size=args.prompt_len, dtype=np.int32),
                    max_new_tokens=args.tokens,
                ))
            t0 = time.time()
            completed = engine.run_to_completion()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return completed, time.time() - t0, engine

        out = {}
        for label, mesh_arg in (("unsharded", None), (f"sharded TP={tp}", mesh)):
            completed, dt, engine = run(mesh_arg)
            n_tok = sum(len(r.generated) for r in completed)
            print(f"\n== engine, {label} ({args.fabric} plan, reduced arch, {device}) ==")
            print(f"{len(completed)} requests, {n_tok} tokens in {dt:.2f}s "
                  f"({n_tok / max(dt, 1e-9):.1f} tok/s)")
            print("sample request 0:", completed[0].generated)
            toks = {r.rid: list(r.generated) for r in completed}
            if mesh_arg is None:
                out["unsharded"] = toks
                continue
            out["sharded"] = toks
            out["match"] = out["unsharded"] == toks
            print(f"tokens match unsharded run: {out['match']}")
            obs = engine.observed_step_time()
            cal = engine.plan  # calibrated copy: wire + probed fixed term
            pred = cal.predicted_step_time()
            wire = cal.schedule.result.t_iter
            print(f"step decomposition: fixed {cal.t_step_fixed * 1e3:.3f}ms "
                  f"(compute+dispatch, probed) + wire {wire * 1e3:.3f}ms "
                  f"(plan timeline) = {pred * 1e3:.3f}ms predicted")
            if obs is not None:
                print(f"observed step: {obs * 1e3:.3f}ms "
                      f"(observed/predicted = {obs / pred:.2f}x)")
            print("per-group predicted vs measured collective:")
            for line in group_comparison_lines(cal, time_serve_groups(cal, mesh)):
                print("  " + line)
        out["tp"] = tp
    finally:
        world.close()
    return out


if __name__ == "__main__":
    main()
