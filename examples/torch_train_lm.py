"""End-to-end training driver (the PyTorch port): a small LM trained with
the whole MG-WFBP stack: the schedule, one all-reduce per schedule group
through the packed gradient arena (the comm_pack kernels on the card),
the flash-attention kernels, the synthetic data stream, async atomic
checkpoints and resume.

    python examples/torch_train_lm.py --steps 200            # ~25M params
    python examples/torch_train_lm.py --steps 300 --full     # ~110M params
    python examples/torch_train_lm.py --steps 40 --tiny      # smoke
    python examples/torch_train_lm.py --steps 40 --tiny --device cpu

It runs on ``cuda`` unless ``--device cpu`` is given, and raises when CUDA
is asked for and missing.  Under ``torchrun`` every rank joins the world
and trains its share of the batch; alone it is a world of one.

The loss must fall well below the unigram entropy of the synthetic
mixture: the stream embeds a repeated motif (``data/pipeline.py``), so a
working model reaches about half its first loss within a few hundred
steps.
"""

import argparse
import dataclasses
import os
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_reduced
from repro_torch.core.sync import SyncConfig
from repro_torch.core.trainer import MGWFBPEngine, batch_to_device
from repro_torch.data import DataConfig, make_stream
from repro_torch.fabric.presets import tpu_psum_model
from repro_torch.kernels import launch_counts
from repro_torch.launch.mesh import ProcessWorld
from repro_torch.models import Attention, Transformer, param_shapes
from repro_torch.optim import make_optimizer


def build_cfg(size: str):
    cfg = get_reduced("tinyllama-1.1b")
    if size == "tiny":
        return dataclasses.replace(cfg, param_dtype=torch.float32)
    if size == "full":  # ~110M params
        return dataclasses.replace(
            cfg,
            name="tinyllama-110m",
            n_layers=8,
            d_model=768,
            d_ff=2048,
            vocab=8192,
            attention=Attention(n_heads=12, n_kv_heads=4, head_dim=64),
            param_dtype=torch.float32,
            q_chunk=64,
        )
    return dataclasses.replace(  # default ~25M
        cfg,
        name="tinyllama-25m",
        n_layers=6,
        d_model=384,
        d_ff=1024,
        vocab=4096,
        attention=Attention(n_heads=6, n_kv_heads=2, head_dim=64),
        param_dtype=torch.float32,
        q_chunk=64,
    )


def main(argv=None):
    """Train; returns ``{'losses', 'first_loss', 'final_loss',
    'step_launches', 'groups'}`` (``step_launches``: each step's kernel
    launches, by wrapper name, nonzero ones only)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--method", default="mg_wfbp",
                    choices=["mg_wfbp", "dp_optimal", "wfbp", "synceasgd", "fixed"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; nothing falls back to the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = build_cfg("tiny" if args.tiny else "full" if args.full else "mid")
    pg = ProcessWorld(device)
    try:
        rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        eng = MGWFBPEngine.build(
            cfg, param_shapes(cfg),
            ar_model=tpu_psum_model({"data": max(world, 2)}),
            tokens_per_device=args.batch * args.seq // world,
            policy=args.method,
            sync_config=SyncConfig(fuse="arena"),
        )
        print(f"schedule: {eng.schedule.describe()}")
        print(f"sync: {eng.sync.n_groups} all-reduces a step through the packed arena, "
              f"world {world}, {device}")

        model = Transformer(cfg, device=device, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"model: {cfg.name}  params: {n_params / 1e6:.1f}M")
        opt = make_optimizer("adamw", weight_decay=0.01)
        step_fn = eng.make_train_step(model, opt, lr=args.lr)

        def ckpt_tree():
            st = step_fn.opt_state
            return {"params": step_fn.params,
                    "opt_state": {"step": st.step, "m": st.m, "v": st.v}}

        start = 0
        ck = latest_step(args.ckpt_dir)
        if ck is not None:
            tree, _ = restore(args.ckpt_dir, ck, ckpt_tree())  # into the live tensors
            step_fn.opt_state.step = tree["opt_state"]["step"]
            start = ck
            print(f"resumed from checkpoint step {ck}")

        data = make_stream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch),
                           host_rank=rank, host_count=world)
        ckpt = AsyncCheckpointer(args.ckpt_dir)

        t0 = time.time()
        first_loss = final = None
        losses, step_launches = [], []
        for step in range(start, args.steps):
            before = launch_counts()
            metrics = step_fn(batch_to_device(data.batch_at(step), device))
            loss = float(metrics["loss"])  # waits for the step
            after = launch_counts()
            step_launches.append({k: after[k] - before[k] for k in after
                                  if after[k] != before[k]})
            losses.append(loss)
            final = loss
            if step % 10 == 0 or step == args.steps - 1:
                if first_loss is None:
                    first_loss = loss
                print(f"step {step:4d}  loss {loss:.4f}  ({time.time() - t0:.1f}s)")
            if (step + 1) % args.ckpt_every == 0 and rank == 0:
                ckpt.save(step + 1, ckpt_tree())
        ckpt.wait()
        step_fn.close()
    finally:
        pg.close()
    if first_loss is None:
        print(f"\nnothing to train: the checkpoint is at step {start} of {args.steps}")
    else:
        print(f"\nloss: {first_loss:.4f} -> {final:.4f} "
              f"({'OK: learned' if final < 0.7 * first_loss else 'WARNING: check'})")
    return {"losses": losses, "first_loss": first_loss, "final_loss": final,
            "step_launches": step_launches, "groups": eng.sync.n_groups}


if __name__ == "__main__":
    main()
