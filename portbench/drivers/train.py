"""Training cells: one data-parallel replica's MG-WFBP step of the program,
built as its launcher builds it, with the seed's weights and batches.

Set-up builds the step object, drives it through its first steps (the
same call and feed as the window, on rows that all differ) and reads what
the comparison needs; the window then trains on with that same object.
After the window the program is freed and the plain reference follows
the first steps from the same weights and batches.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .. import check, counts, devtrace, traffic, weights
from ..reference import train as ref_train
from ..reference.common import no_tf32

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(config: dict, reduced: bool = False):
    """The program's ``ArchConfig`` for the configuration file (its arch at
    the program's reduced widths with ``reduced``), with the file's
    ``program_overrides``: top-level fields, and ``attention``'s as a dict."""
    from repro_torch.configs import get_config, get_reduced

    over = dict(config["program_overrides"])
    cfg = (get_reduced if reduced else get_config)(config["arch"])
    if "attention" in over:
        over["attention"] = dataclasses.replace(cfg.attention, **over["attention"])
    return dataclasses.replace(cfg, attn_impl="flash", **over)


def matches(config: dict, arch) -> None:
    """Raise if the program would run other sizes than the file states."""
    a = arch.attention
    got = {"n_layers": arch.n_layers, "d_model": arch.d_model, "d_ff": arch.d_ff,
           "vocab": arch.vocab, "norm": arch.norm, "mlp": arch.mlp,
           "tie_embeddings": arch.tie_embeddings,
           # the program scales a tied table's rows by sqrt(d_model)
           "embed_scale": arch.d_model ** 0.5 if arch.tie_embeddings else 1.0,
           "param_dtype": str(arch.param_dtype).removeprefix("torch."),
           "n_heads": a.n_heads, "n_kv_heads": a.n_kv_heads, "head_dim": a.head_dim,
           "rope_theta": a.rope_theta}
    bad = {k: (v, config.get(k)) for k, v in got.items() if config.get(k) != v}
    if bad:
        raise ValueError(f"the program's config differs from the file (program, file): {bad}")


class Program:
    """The program's training step over the seed's weights."""

    def __init__(self, config: dict, options: dict, device: torch.device, seed: int,
                 tokens_per_rank: int, arch=None):
        from repro_torch.core.sync import SyncConfig
        from repro_torch.core.trainer import MGWFBPEngine
        from repro_torch.fabric import get_fabric
        from repro_torch.launch.mesh import ProcessWorld
        from repro_torch.models.transformer import Transformer, param_shapes
        from repro_torch.optim import make_optimizer

        arch = program_config(config) if arch is None else arch
        matches(config, arch)
        self.config, self.device, self.seed = config, device, seed
        if device.type == "cuda":
            torch.cuda.set_device(device)
        self.pg = ProcessWorld(device)
        try:
            sync_cfg = SyncConfig(comm_dtype=DTYPES[options["comm_dtype"]], compression=None,
                                  fuse=options["fuse"])
            ar_model = get_fabric(options["fabric"]).cost("all_reduce",
                                                          {"data": options["virtual_dp"]})
            self.engine = MGWFBPEngine.build(arch, param_shapes(arch), ar_model=ar_model,
                                             tokens_per_device=tokens_per_rank,
                                             policy=options["policy"], sync_config=sync_cfg)
            self.model = Transformer(arch, device=device, seed=None)
            self.params = dict(self.model.named_parameters())
            weights.fill(self.params, config, seed)
            opt = config["optimizer"]
            self.optimizer = make_optimizer("adamw", b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                                            weight_decay=opt["weight_decay"])
            self.issue = options["issue_order"]
            self.step_fn = self.engine.make_train_step(self.model, self.optimizer, lr=opt["lr"],
                                                       issue=self.issue)
        except BaseException:
            self.pg.close()
            raise

    def reseed(self, seed: int) -> None:
        """Start again from ``seed``'s weights with a fresh optimizer state."""
        self.step_fn.close()
        del self.step_fn
        weights.fill(self.params, self.config, seed)
        self.seed = seed
        self.step_fn = self.engine.make_train_step(self.model, self.optimizer,
                                                   lr=self.config["optimizer"]["lr"],
                                                   issue=self.issue)

    def step(self, batch: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return self.step_fn({"tokens": batch[0], "targets": batch[1]})["loss"]

    @torch.no_grad()
    def first_steps(self, batches) -> dict:
        """Run the first steps and read each step's loss, each leaf's step-1
        gradient norm (from AdamW's first moment, ``m = (1 - b1) g``) and
        each leaf's change over the steps."""
        b1 = self.config["optimizer"]["b1"]
        out = {"losses": []}
        for s, batch in enumerate(batches):
            with torch.enable_grad():
                out["losses"].append(float(self.step(batch)))
            if s == 0:
                moment = self.step_fn.opt_state.m
                out["grad_norms"] = {n: float(torch.linalg.vector_norm(m.double())) / (1.0 - b1)
                                     for n, m in moment.items()}
        change = {}
        for g in weights.groups(self.config):
            first = weights.draw(g, self.seed, self.device)
            for n, row in zip(g.leaves, first.unbind(0)):
                change[n] = float(torch.linalg.vector_norm(self.params[n].double() - row.double()))
            del first
        out["change_norms"] = change
        return out

    def counters(self) -> dict:
        """What the per-layer readers count work from."""
        return {"param_bytes": sum(p.numel() * p.element_size() for p in self.params.values()),
                "param_elems": sum(p.numel() for p in self.params.values()),
                "groups": self.engine.sync.n_groups}

    def close(self) -> None:
        self.step_fn.close()
        self.pg.close()
        del self.step_fn, self.model, self.params, self.engine


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_window(prog: Program, batches, seconds: float, start: int) -> tuple[list, float]:
    """Steps until ``seconds`` have passed on the host clock, then wait for
    the device: every step enqueued is in the window, and so is its time."""
    sync(prog.device)
    losses, i = [], start
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        losses.append(prog.step(batches[i % len(batches)]))
        i += 1
    sync(prog.device)
    return losses, time.perf_counter() - t0


def traced_window(prog: Program, batches, steps: int, start: int):
    """``steps`` steps under the profiler, which records the device's
    activity alone (kernels, copies and the runtime calls that launched
    them): recording every host operator too would slow the host's
    dispatch by more than the step's slack and charge that to the step."""
    from torch.profiler import ProfilerActivity, profile

    cuda = prog.device.type == "cuda"
    sync(prog.device)
    losses = []
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for i in range(start, start + steps):
            losses.append(prog.step(batches[i % len(batches)]))
        sync(prog.device)
        wall = time.perf_counter() - t0
    return losses, devtrace.from_profile(prof, wall, steps)


def reference_readings(config: dict, mix: dict, seed: int, device, steps: int,
                       precision: str = "float32", keep_tokens: int | None = None) -> dict:
    """The reference's readings over the same first steps, batches and
    initial weights."""
    no_tf32()
    store = weights.initial(config, seed, device)
    batches = traffic.lm_batches(mix, config["vocab"], seed, device)[:steps]
    return ref_train.readings(store, config, batches, steps, precision, keep_tokens)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        arch=None) -> dict:
    """One run of a one-rank training cell: the result's parts."""
    config, mix, w = cell.config, cell.traffic, cell.workload
    B, S = mix["batch"], mix["seq"]
    n_first = w["check_steps"]
    prog = Program(config, w["program"], device, seed, B * S, arch)
    batches = traffic.lm_batches(mix, config["vocab"], seed, device)
    first = prog.first_steps(batches[:n_first])
    sync(device)
    setup_s = time.perf_counter() - t_start
    out = {"setup_s": setup_s}
    if trace:
        losses, window = traced_window(prog, batches, w["trace_steps"], n_first)
        out["window"] = window
        out["ctx"] = {"config": config, "mix": mix, "chips": 1, "tokens_per_step": B * S,
                      "step_flops": counts.step_flops(config, B, S),
                      "wire_itemsize": DTYPES[w["program"]["comm_dtype"]].itemsize,
                      **prog.counters()}
    else:
        losses, wall = timed_window(prog, batches, seconds, n_first)
        out["measures"] = {"train_tok_s": len(losses) * B * S / wall, "setup_s": setup_s}
        out["window_s"] = wall
    out["attempted"] = len(losses)
    out["failed"] = int((~torch.isfinite(torch.stack(losses).float())).sum()) if losses else 0
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prog.close()
    del prog, batches, losses
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(config, mix, seed, device, n_first)
    out["numbers"] = check.train_numbers(first, ref)
    return out
