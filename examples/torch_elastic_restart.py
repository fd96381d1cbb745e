"""Fault tolerance and elasticity (the PyTorch port): train, inject a
failure, restore from the atomic checkpoint, and (the elastic part)
recompute the MG-WFBP schedule for another cluster size.  The checkpoint
layout does not depend on the schedule, so the same weights resume under
another bucket structure (paper Algorithm 1 reruns with the new N's α–β
model).

Phase 3 is the serving mirror: snapshot a ServingEngine mid-generation,
"kill" it, restore into a fresh engine, and check that the resumed run
emits exactly the tokens of the uninterrupted run.

    python examples/torch_elastic_restart.py [--device cpu]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises when CUDA
is asked for and missing.
"""

import argparse
import dataclasses
import os
import pathlib
import shutil
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import latest_step, load_plan, restore
from repro_torch.configs import get_reduced
from repro_torch.core.trainer import MGWFBPEngine, batch_to_device
from repro_torch.data import DataConfig, make_stream
from repro_torch.fabric.presets import tpu_psum_model
from repro_torch.launch.mesh import ProcessWorld
from repro_torch.models import Transformer, param_shapes
from repro_torch.optim import make_optimizer
from repro_torch.runtime import RunState, StragglerMonitor, resilient_loop
from repro_torch.serving import (
    Request,
    ServingEngine,
    restore_latest_snapshot,
    save_snapshot,
)


def make_engine(cfg, shapes, n_virtual: int, world: int):
    """The schedule as it would be on an n_virtual-card DP group."""
    return MGWFBPEngine.build(
        cfg, shapes,
        ar_model=tpu_psum_model({"data": n_virtual}),
        tokens_per_device=2048 // max(world, 1),
        policy="mg_wfbp",
    )


def main(argv=None):
    """Run the three phases; returns ``{'restarts', 'resumed_step',
    'expected', 'resumed'}`` (the serving tokens, ``{rid: tokens}``)."""
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; nothing falls back to the CPU")
    ap.add_argument("--ckpt-dir", default=os.path.join(tmp, "repro_torch_elastic_ckpt"))
    ap.add_argument("--snapshot-dir",
                    default=os.path.join(tmp, "repro_torch_elastic_serve_snap"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ckpt_dir, snap_dir = args.ckpt_dir, args.snapshot_dir

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = dataclasses.replace(get_reduced("tinyllama-1.1b"), param_dtype=torch.float32)
    shapes = param_shapes(cfg)
    pg = ProcessWorld(device)
    try:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        world = torch.distributed.get_world_size()
        opt = make_optimizer("adamw")
        data = make_stream(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8),
                           host_rank=torch.distributed.get_rank(), host_count=world)
        model = Transformer(cfg, device=device, seed=0)

        # phase 1: the "16-card" schedule
        eng16 = make_engine(cfg, shapes, 16, world)
        print("schedule @ N=16:", eng16.schedule.describe())
        step16 = eng16.make_train_step(model, opt, lr=1e-3)

        def live_state(step: int, restarts: int) -> RunState:
            return RunState(step=step, params=step16.params, opt_state=step16.opt_state,
                            restarts=restarts)

        def init_state() -> RunState:
            """Step 0's state in the live tensors: the weights of seed 0
            again and AdamW's moments zeroed."""
            with torch.no_grad():
                model.reset_parameters(0)
                for t in (*step16.opt_state.m.values(), *step16.opt_state.v.values()):
                    t.zero_()
            step16.opt_state.step = 0
            return live_state(0, 0)

        crashes = {25}

        def fault(step):
            if step in crashes:
                crashes.discard(step)
                raise RuntimeError(f"injected node failure at step {step}")

        def do_step(state, step):
            step16(batch_to_device(data.batch_at(step), device))
            return live_state(state.step, state.restarts)

        mon = StragglerMonitor(factor=3.0, patience=3)
        state = resilient_loop(
            num_steps=40, init_state=init_state, train_step=do_step,
            checkpoint_dir=ckpt_dir, checkpoint_every=10,
            fault_injector=fault, straggler=mon,
            # plan-aware checkpoints: every checkpoint carries the plan in effect
            plan_provider=lambda: eng16.plan,
        )
        print(f"phase 1 done: step={state.step} restarts={state.restarts} "
              f"(failure at 25 -> restored from step 20)")

        # Same-N restart: the plan rides beside the weights; reload it instead
        # of rerunning Algorithm 1, and resume under the exact schedule the
        # run crashed with
        ck = latest_step(ckpt_dir)
        stored = load_plan(ckpt_dir, ck)
        assert stored == eng16.plan
        eng_resumed = MGWFBPEngine.build(cfg, None, plan=stored)
        assert eng_resumed.schedule.groups == eng16.schedule.groups
        print(f"plan restored from checkpoint step {ck}: {stored.describe()}")

        # phase 2: the cluster grew to "64 cards": an elastic restart from the
        # same checkpoint (the weights do not depend on the schedule), the
        # stored plan's α–β model is the old N's, so the policy re-plans
        eng64 = make_engine(cfg, shapes, 64, world)
        print("schedule @ N=64:", eng64.schedule.describe())
        model64 = Transformer(cfg, device=device, seed=None)
        step64 = eng64.make_train_step(model64, opt, lr=1e-3)
        st = step64.opt_state
        tree, _ = restore(ckpt_dir, ck, {"params": step64.params,
                                         "opt_state": {"step": st.step, "m": st.m, "v": st.v}})
        st.step = tree["opt_state"]["step"]
        for s in range(ck, ck + 5):
            m = step64(batch_to_device(data.batch_at(s), device))
        print(f"phase 2: resumed step {ck} under the N=64 schedule, "
              f"5 more steps OK (loss {float(m['loss']):.3f})")
        step16.close()
        step64.close()
        del model64
    finally:
        pg.close()

    # phase 3: serve-side restart: snapshot mid-generation, kill the engine,
    # restore into a fresh one, and the resumed decode emits token for token
    # what the uninterrupted run would have
    shutil.rmtree(snap_dir, ignore_errors=True)
    serve_model = Transformer(cfg, device=device, seed=0)

    def make_serve_engine():
        return ServingEngine(cfg, serve_model, slots=2, max_seq=64)

    def submit_all(eng):
        rng = np.random.default_rng(0)
        for rid in range(3):
            eng.submit(Request(
                rid=rid,
                prompt=rng.integers(0, cfg.vocab, size=8, dtype=np.int32),
                max_new_tokens=12,
            ))

    ref = make_serve_engine()
    submit_all(ref)
    expected = {r.rid: list(r.generated) for r in ref.run_to_completion()}

    eng = make_serve_engine()
    submit_all(eng)
    for _ in range(5):
        eng.step()
    save_snapshot(eng, snap_dir, 5)
    del eng  # the "kill": the mid-generation engine is gone

    fresh = make_serve_engine()
    step, _ = restore_latest_snapshot(fresh, snap_dir)
    while fresh.active or fresh.waiting:
        fresh.step()
    resumed = {r.rid: list(r.generated) for r in fresh.completed}
    assert resumed == expected, "restored decode diverged from baseline"
    print(f"phase 3: serve snapshot at step {step} restored into a fresh "
          f"engine; all {len(resumed)} requests token-identical to the "
          f"uninterrupted run")
    return {"restarts": state.restarts, "resumed_step": ck, "expected": expected,
            "resumed": resumed}


if __name__ == "__main__":
    main()
