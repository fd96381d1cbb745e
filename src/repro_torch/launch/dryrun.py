"""Multi-pod dry run on a fake world (counterpart of ``repro/launch/dryrun.py``):
run every (architecture x input shape x mesh) cell once, prove its memory
fits, and derive the roofline terms.

For each cell this module:

  1. starts a fake process group of 256 (16x16) or 512 (2x16x16) ranks in
     this one process and a ``DeviceMesh`` shaped like
     ``launch.mesh.make_production_mesh`` over it (``segments.fake_world``);
  2. builds the whole step's parameters, optimizer state, batch and caches
     as fake DTensors placed by ``parallel.sharding``'s rules, and runs the
     step once (``launch.steps``): nothing is allocated or computed;
  3. records each device's memory: the exact bytes of its local shards of
     the arguments and outputs, plus the activation peak ``MemTracker``
     reports for the step's local computation (``memory``, its
     ``peak_per_device_gib`` printed against the H100's 80 GB);
  4. counts the step's per-device flops, bytes and collectives
     (``whole_program``, by ``segments.CostMode``'s rule).  The JAX count
     undercounts the layer ``scan`` (XLA counts its body once); this one
     runs every layer, and the recompute of ``remat='full'`` or ``'dots'``
     too (under ``'dots'`` the saved products, and the redistributions that
     feed them, do not run again);
  5. runs the cost segments (``segments.py``, remat off) and recomposes the
     per-device totals and the three roofline terms (``recompose``), with
     the roofline constants passed in: the H100 SXM's (989e12 dense bf16
     FLOP/s, 3.35e12 B/s of HBM) and the ``gpu_nccl`` preset's 200e9 B/s
     link (a preset, not a measurement) from the CLI;
  6. adds the train plan (``plan_record``) or the decode serve plan
     (``serve_plan_record``), priced on ``--fabric``, and writes one JSON
     record per cell under ``build/dryrun_torch/`` (never
     ``benchmarks/results/``).

Usage::

  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k --device cpu
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-segments]

The fake world runs on the host in any case; like every entry point the
CLI resolves ``--device`` (CUDA unless ``--device cpu``) and raises when
CUDA is missing.  No ``XLA_FLAGS`` are set.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import textwrap
import time
import traceback

import torch

from ..configs import ARCH_NAMES, get_config
from ..configs.shapes import LONG_CONTEXT_SKIP, SHAPES, applicable_shapes
from ..core.cost_model import TPU_V5E, Hardware
from ..devices import resolve_device
from ..fabric import available_fabrics
from ..fabric.presets import GPU_NCCL
from ..models.transformer import REMATS, Transformer, _flatten
from ..optim import make_optimizer
from ..optim.optimizers import OptState
from ..parallel.sharding import batch_specs, cache_pspecs, is_spec, param_pspecs, rules_for_arch
from .mesh import make_production_mesh
from .segments import (
    counting,
    distribute_module,
    distribute_tree,
    fake_world,
    head_fwd_segment,
    head_train_segment,
    keeps_experts,
    stage_fwd_segment,
    stage_train_segment,
    local_nbytes,
    tree_get,
)
from .specs import (
    arch_config_for_shape,
    batch_input_specs,
    cache_specs,
    decode_input_specs,
    moe_groups_for,
    param_specs,
)
from .steps import make_decode_step, make_prefill_step, make_train_step

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
H100_HBM_BYTES = 80 * 10**9


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Per-device roofline denominators, and the ``Hardware`` the plans'
    analytic compute costs use."""

    name: str
    peak_flops: float  # FLOP/s
    hbm_bw: float  # B/s
    link_bw: float  # B/s
    hw: Hardware


#: The H100 SXM: 989e12 dense bf16 FLOP/s and 3.35e12 B/s of HBM (the
#: figures ``chip_smoke.py``'s bounds use); the link is the ``gpu_nccl``
#: preset's 200e9 B/s.
H100_SXM = Roofline("h100_sxm", 989e12, 3.35e12, GPU_NCCL.ici_link_bw,
                    Hardware(name="nvidia_h100_sxm", peak_flops=989e12, hbm_bw=3.35e12))
#: The JAX dry run's v5e constants, to compare the two records.
TPU_V5E_ROOFLINE = Roofline("tpu_v5e", 197e12, 819e9, 50e9, TPU_V5E)


def _axis_sizes(mesh) -> dict[str, int]:
    """``{name: size}`` of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def model_flops_per_step(cfg, shape) -> float:
    """Paper-style useful flops: 6·N_active·tokens (train), 2·N_active·tokens (serve)."""
    leaves = _flatten(param_specs(cfg))
    n_total = sum(math.prod(t.shape) for _, t in leaves)
    if cfg.moe is not None:
        n_exp = sum(math.prod(t.shape) for path, t in leaves
                    if path[0] == "stages" and any(k in ("w_gate", "w_up", "w_down") for k in path))
        n_active = n_total - n_exp + n_exp * cfg.moe.top_k / cfg.moe.n_experts
    else:
        n_active = n_total
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per row


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def _param_spec_of(pspecs: dict):
    """A per-layer parameter name -> its spec in the stacked tree (a stage's
    leaves drop the stacked axis)."""

    def spec_of(name: str) -> tuple:
        parts = name.split(".")
        if parts[0] == "stages":
            return tuple(tree_get(pspecs["stages"], parts[2:]))[1:]
        return tree_get(pspecs, parts)

    return spec_of


def _placed_batch(meta: dict, specs: dict, mesh) -> dict:
    """The batch as fake DTensors, token ids as int64 (the JAX inputs'
    int32 ids index the same way)."""
    return {k: distribute_tree(v, specs[k], mesh,
                               torch.int64 if k in ("tokens", "targets") else None)
            for k, v in meta.items()}


def _like(p, dtype):
    from torch.distributed.tensor import DTensor

    loc = torch.empty(p._local_tensor.shape, dtype=dtype, device="meta")
    return DTensor.from_local(loc, p.device_mesh, p.placements, run_check=False,
                              shape=p.shape, stride=p.stride())


def _mem_tracker():
    """A ``MemTracker`` of the local shards' memory.  DTensor works out each
    op's global output shape on fake tensors of a fake mode of its own;
    the local shards are ``meta`` tensors, under no fake mode, so an op run
    under a fake mode is one of DTensor's and is not tracked (newer
    ``MemTracker``s tell them apart the same way).  It keeps the global
    peak only: the per-module peaks cost a pass over every tracked module
    at every op."""
    from torch.distributed._tools import mem_tracker
    from torch.distributed.tensor import DTensor

    class PeakTracker(mem_tracker.MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if mem_tracker.active_fake_mode() is not None and DTensor not in types:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _update_peak_stats(self, peak_state) -> None:
            for dev, dev_snap in self._curr_mem_snap.items():
                if self._peak_mem.get(dev, 0) < dev_snap["Total"]:
                    self._peak_mem[dev] = dev_snap["Total"]
                    self._peak_mem_snap[dev] = dict(dev_snap)

    return PeakTracker()


def _peak_bytes(tracker) -> int:
    """The activation peak of a ``MemTracker`` run: its peak snapshot less
    the parameters, buffers and optimizer state it saw (they are counted
    as arguments)."""
    total = 0
    for snap in tracker.get_tracker_snapshot("peak").values():
        by_kind = {getattr(k, "value", k): v for k, v in snap.items()}
        total += by_kind["Total"] - sum(by_kind.get(k, 0) for k in ("Parameter", "Buffer", "Optstate"))
    return int(total)


def _run_step(cfg, shape, rules, mesh, n_microbatches: int,
              by_op: dict | None = None) -> tuple[dict, dict]:
    """Build the cell's placed fake state, run its step once under the
    counters, and return the record's ``memory`` and ``whole_program``;
    ``by_op`` (when given) receives each collective kind's count by the
    op whose placements required it."""
    B, S = shape.global_batch, shape.seq_len
    pspecs = param_pspecs(param_specs(cfg), rules)
    model = Transformer(cfg, device="meta", seed=None)
    tokens = B * (S if shape.kind != "decode" else 1)
    distribute_module(model, _param_spec_of(pspecs), mesh,
                      keep_experts=keeps_experts(cfg, rules, tokens))
    params_b = local_nbytes(list(model.parameters()))
    tracker = _mem_tracker()
    if shape.kind == "train":
        opt = make_optimizer("adamw")
        named = dict(model.named_parameters())
        opt_state = OptState(step=0, m={n: _like(p, torch.float32) for n, p in named.items()},
                             v={n: _like(p, torch.float32) for n, p in named.items()})
        opt_b = local_nbytes(opt_state.m) + local_nbytes(opt_state.v) + 4
        batch = _placed_batch(batch_input_specs(cfg, shape), batch_specs(cfg, rules, B, S),
                              mesh)
        step = make_train_step(cfg, rules, opt, n_microbatches=n_microbatches)
        args_b = params_b + opt_b + local_nbytes(batch)
        with tracker, counting() as mode:
            step(model, opt_state, batch)
        out_b, alias_b = params_b + opt_b + 8, params_b + opt_b
    else:
        c_meta = cache_specs(cfg, batch=B, max_seq=S)
        caches = distribute_tree(c_meta, cache_pspecs(cfg, rules, c_meta, B), mesh)
        cache_b = local_nbytes(caches)
        if shape.kind == "prefill":
            b_meta = batch_input_specs(cfg, shape)
            b_meta.pop("targets")
            bsp = batch_specs(cfg, rules, B, S)
            bsp.pop("targets")
            step = make_prefill_step(cfg, S, rules=rules)
            call = lambda b: step(model, b, caches)
        else:
            b_meta = decode_input_specs(cfg, shape)
            bsp = batch_specs(cfg, rules, B, 1)
            bsp.pop("targets")
            step = make_decode_step(cfg, rules)
            call = lambda b: step(model, caches, b, S - 1)
        batch = _placed_batch(b_meta, bsp, mesh)
        args_b = params_b + cache_b + local_nbytes(batch)
        with tracker, counting() as mode:
            logits, _ = call(batch)
        out_b = cache_b + local_nbytes(logits)
        alias_b = cache_b
    temp_b = _peak_bytes(tracker)
    memory = {
        "argument_bytes": int(args_b),
        "output_bytes": int(out_b),
        "temp_bytes": int(temp_b),
        "alias_bytes": int(alias_b),
        "peak_per_device_gib": round((args_b + out_b + temp_b - alias_b) / 2**30, 3),
    }
    t = mode.tally
    if by_op is not None:
        by_op.update(sorted(t.coll_by_op.items(), key=lambda kv: (-kv[1], kv[0])))
    whole = {
        "flops_per_device": float(t.flops),
        "bytes_accessed": float(t.bytes),
        "collectives": {"counts": dict(t.coll_counts), "bytes_by_kind": dict(t.coll_bytes),
                        "concat_ops": int(t.concat_ops)},
    }
    return memory, whole


def dry_cell(arch: str, shape_name: str, multi_pod: bool, fsdp_data=True,
             n_microbatches: int = 1, skip_segments: bool = False,
             overrides: dict | None = None, comm_fit: dict | None = None,
             fabric: str = "gpu_nccl", roofline: Roofline = H100_SXM) -> dict:
    """The counterpart of the JAX ``lower_cell``: one cell's record, with
    the JAX record's keys."""
    shape = SHAPES[shape_name]
    n_dev = 512 if multi_pod else 256
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        cfg = arch_config_for_shape(arch, shape_name)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        rules = rules_for_arch(cfg, mesh, fsdp_data=fsdp_data)
        # GShard groups: a multiple of the token-shard count, tg ~ 4096
        seq_for_groups = shape.seq_len if shape.kind != "decode" else 1
        cfg = dataclasses.replace(
            cfg, moe_groups=moe_groups_for(rules, shape.global_batch, seq_for_groups))
        rec = {
            "arch": arch,
            "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "n_devices": n_dev,
            "fsdp_data": fsdp_data,
            "n_microbatches": n_microbatches,
        }
        t0 = time.time()
        by_op: dict = {}
        rec["memory"], rec["whole_program"] = _run_step(cfg, shape, rules, mesh, n_microbatches,
                                                        by_op)
        rec["compile_s"] = round(time.time() - t0, 1)
        mem, wp = rec["memory"], rec["whole_program"]
        print(f"[{arch} x {shape_name} x {rec['mesh']}] fake step {rec['compile_s']}s")
        print(f"  memory: peak_per_device_gib {mem['peak_per_device_gib']} "
              f"({mem['peak_per_device_gib'] * 2**30 / H100_HBM_BYTES:.1%} of the H100's 80 GB; "
              f"args {mem['argument_bytes']} out {mem['output_bytes']} "
              f"temp {mem['temp_bytes']} alias {mem['alias_bytes']})")
        print(f"  whole_program flops/device: {wp['flops_per_device']:.6e}, "
              f"collectives {wp['collectives']['counts']}")
        print(f"  collectives by op: {json.dumps(by_op)}")
        if not skip_segments:
            rec["segments"] = segment_costs(arch, shape_name, mesh, rules, overrides)
            rec["totals"] = recompose(cfg, shape, rec, n_dev, roofline)
            tot = rec["totals"]
            print(f"  totals: dominant {tot['dominant']}, roofline_fraction "
                  f"{tot['roofline_fraction']:.4f}, bound {tot['roofline_bound_s']:.6e}s "
                  f"(compute {tot['compute_term_s']:.6e}, memory {tot['memory_term_s']:.6e}, "
                  f"collective {tot['collective_term_s']:.6e}; {roofline.name})")
        if shape.kind == "train":
            rec["plan"] = plan_record(cfg, shape, rec.get("segments"), mesh, n_dev,
                                      comm_fit=comm_fit, fabric=fabric, roofline=roofline)
            groups = rec["plan"]["analytic"]["schedule"]["groups"]
            print(f"  plan: {len(groups)} groups {groups}")
        elif shape.kind == "decode":
            rec["serve_plan"] = serve_plan_record(cfg, shape, mesh, fabric=fabric, roofline=roofline)
    return rec


def serve_plan_record(cfg, shape, mesh, fabric: str = "gpu_nccl",
                      roofline: Roofline = H100_SXM) -> dict:
    """Serialized decode-side ServePlan for this cell: the same merge math
    as the train plan, pricing the decode collective (KV all-gather /
    expert all-to-all) on the selected fabric over the mesh's model axis."""
    from ..planning import build_serve_plan

    axis_sizes = _axis_sizes(mesh)
    plan = build_serve_plan(
        cfg, param_specs(cfg), fabric,
        {"model": axis_sizes.get("model", 1)},
        batch_rows=shape.global_batch,
        hw=roofline.hw,
        provenance={"shape": shape.name},
    )
    print(textwrap.indent(plan.describe(), "  "))
    return plan.to_json_dict()


def plan_record(cfg, shape, segs, mesh, n_dev, comm_fit=None,
                fabric: str = "gpu_nccl", roofline: Roofline = H100_SXM) -> dict:
    """Serialized MG-WFBP plan(s) for this train cell.

    The analytic plan comes from Eq. 18 costs priced by the ``--fabric``
    preset; with segment costs, a measured plan re-runs the policy on
    per-unit segment times (``MeasuredCosts.from_segment_times``), the
    segment roofline time split 1/3 forward and 2/3 backward.
    ``comm_fit`` (a serialized ``MeasuredComm`` sweep) swaps the analytic
    α–β model for a measured fit.  Each plan carries its per-group arena
    wire layout."""
    from ..core.bucketing import stacked_lm_layout
    from ..core.trainer import lm_unit_costs
    from ..fabric import get_fabric
    from ..planning import MeasuredComm, MeasuredCosts, build_plan, replan_if_drifted

    axis_sizes = _axis_sizes(mesh)
    model_shards = axis_sizes.get("model", 1)
    dp_axes = {k: v for k, v in axis_sizes.items() if k in ("pod", "data")}
    shapes_tree = param_specs(cfg)
    costs = lm_unit_costs(
        cfg, shapes_tree,
        tokens_per_device=shape.global_batch * shape.seq_len // n_dev,
        hw=roofline.hw,
        model_shards=model_shards,
    )
    layout = stacked_lm_layout(shapes_tree, cfg.n_stages, model_shards=model_shards)
    if comm_fit is not None:
        ar_model = MeasuredComm(
            sizes_bytes=tuple(comm_fit["sizes_bytes"]),
            times_s=tuple(comm_fit["times_s"]),
            axes=tuple(comm_fit.get("axes", ("data",))),
        ).fit()
        comm_source = "measured_comm"
    else:
        ar_model = get_fabric(fabric).cost("all_reduce", dp_axes)
        comm_source = fabric
    plan = build_plan(
        layout, costs, ar_model,
        policy="mg_wfbp", hw=roofline.hw, n_scan_stages=cfg.n_stages,
        provenance={"arch": cfg.name, "comm_source": comm_source},
    )
    out = {"analytic": plan.to_json_dict()}
    out["arena"] = [
        {"nbytes": a.nbytes, "n_slots": len(a.slots)}
        for a in plan.group_arenas(shapes_tree)
    ]
    if segs:
        def seg_t(s):
            return max(s["flops"] / roofline.peak_flops, s["bytes_accessed"] / roofline.hbm_bw)

        unit_seconds = {f"stage_{i}": 2 / 3 * seg_t(segs["stage"]) for i in range(cfg.n_stages)}
        if "tail" in segs:
            unit_seconds["tail"] = 2 / 3 * seg_t(segs["tail"])
        unit_seconds["head"] = 2 / 3 * seg_t(segs["head"])
        measured = MeasuredCosts.from_segment_times(
            costs, roofline.hw, unit_seconds, name="hlo_segments"
        )
        mplan, replanned = replan_if_drifted(plan, measured, threshold=0.05)
        out["measured"] = mplan.to_json_dict()
        out["replanned"] = replanned
    return out


def segment_costs(arch: str, shape_name: str, mesh, rules, overrides=None) -> dict:
    """The cell's segments (``segments.py``), at ``cost_mode``'s config."""
    shape = SHAPES[shape_name]
    cfg = arch_config_for_shape(arch, shape_name, cost_mode=True)
    if overrides:
        cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides.items() if k != "remat"})
    seq_for_groups = shape.seq_len if shape.kind != "decode" else 1
    cfg = dataclasses.replace(
        cfg, moe_groups=moe_groups_for(rules, shape.global_batch, seq_for_groups))
    B, S = shape.global_batch, shape.seq_len
    out = {}
    if shape.kind == "train":
        out["stage"] = dataclasses.asdict(stage_train_segment(cfg, rules, mesh, B, S))
        if cfg.tail_pattern:
            out["tail"] = dataclasses.asdict(
                stage_train_segment(cfg, rules, mesh, B, S, pattern=cfg.tail_pattern))
        out["head"] = dataclasses.asdict(head_train_segment(cfg, rules, mesh, B, S))
    elif shape.kind == "prefill":
        out["stage"] = dataclasses.asdict(stage_fwd_segment(cfg, rules, mesh, B, S))
        if cfg.tail_pattern:
            out["tail"] = dataclasses.asdict(
                stage_fwd_segment(cfg, rules, mesh, B, S, pattern=cfg.tail_pattern))
        out["head"] = dataclasses.asdict(head_fwd_segment(cfg, rules, mesh, B, S))
    else:  # decode: one stage with caches
        c_shapes = cache_specs(cfg, batch=B, max_seq=S)
        c_specs = cache_pspecs(cfg, rules, c_shapes, B)
        one_stage_c = _map_leaves(lambda t: t[0], c_shapes["stages"])
        one_stage_sh = _map_leaves(lambda s: tuple(s)[1:], c_specs["stages"], is_leaf=is_spec)
        out["stage"] = dataclasses.asdict(stage_fwd_segment(
            cfg, rules, mesh, B, 1, caches=one_stage_c, cache_sh=one_stage_sh, pos_value=S - 2))
        if cfg.tail_pattern:
            out["tail"] = dataclasses.asdict(stage_fwd_segment(
                cfg, rules, mesh, B, 1, caches=c_shapes["tail"], cache_sh=c_specs["tail"],
                pos_value=S - 2, pattern=cfg.tail_pattern))
        out["head"] = dataclasses.asdict(head_fwd_segment(cfg, rules, mesh, B, 1))
    return out


def _map_leaves(fn, tree, is_leaf=None):
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v, is_leaf) for v in tree)
    return fn(tree)


def recompose(cfg, shape, rec, n_dev, roofline: Roofline = H100_SXM) -> dict:
    """Per-device totals (head + stage x n_stages + tail) and the three
    roofline terms under ``roofline``'s constants."""
    segs = rec["segments"]
    n_stages = cfg.n_stages

    def total(field):
        t = segs["head"][field] + segs["stage"][field] * n_stages
        if "tail" in segs:
            t += segs["tail"][field]
        return t

    flops_dev = total("flops")
    bytes_dev = total("bytes_accessed")
    coll_bytes_dev = (
        sum(segs["head"]["coll_bytes"].values())
        + sum(segs["stage"]["coll_bytes"].values()) * n_stages
        + (sum(segs["tail"]["coll_bytes"].values()) if "tail" in segs else 0)
    )
    mf = model_flops_per_step(cfg, shape)
    compute_t = flops_dev / roofline.peak_flops
    memory_t = bytes_dev / roofline.hbm_bw
    coll_t = coll_bytes_dev / roofline.link_bw
    dom = max(("compute", compute_t), ("memory", memory_t), ("collective", coll_t),
              key=lambda kv: kv[1])[0]
    bound = max(compute_t, memory_t, coll_t)
    return {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_bytes_dev,
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / flops_dev if flops_dev else 0.0,
        "compute_term_s": compute_t,
        "memory_term_s": memory_t,
        "collective_term_s": coll_t,
        "dominant": dom,
        "roofline_bound_s": bound,
        "ideal_compute_s": mf / n_dev / roofline.peak_flops,
        "roofline_fraction": (mf / n_dev / roofline.peak_flops) / bound if bound > 0 else 0.0,
    }


def main(argv: list[str] | None = None, overrides: dict | None = None) -> int:
    """The CLI; ``overrides`` (from Python) replaces config fields of every
    cell, as the train launcher's ``run(argv, overrides=...)`` does (depth
    and width have no flag, in the JAX CLI either)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp-data", action="store_true",
                    help="paper-faithful baseline: params replicated over data")
    ap.add_argument("--remat", default=None, choices=list(REMATS),
                    help="override the shape's remat (the segments count with it off)")
    ap.add_argument("--qchunk", type=int, default=None)
    ap.add_argument("--serve-sharding", default="experts_only",
                    choices=["experts_only", "full", "model_only"],
                    help="decode param sharding override")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--skip-segments", action="store_true")
    ap.add_argument("--comm-fit", default=None,
                    help="JSON file with a serialized MeasuredComm sweep "
                         "({sizes_bytes, times_s[, axes]}); plan records use "
                         "its α–β fit instead of the analytic fabric model")
    ap.add_argument("--fabric", default="gpu_nccl", choices=list(available_fabrics()),
                    help="interconnect preset pricing the plan records "
                         "(train plans and decode serve plans)")
    ap.add_argument("--out", default=None, help="the record's path (one cell); default "
                    "build/dryrun_torch/<arch>__<shape>__<mesh>.json")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the fake world runs on the host either way")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    comm_fit = json.loads(pathlib.Path(args.comm_fit).read_text()) if args.comm_fit else None

    cells = []
    if args.all:
        cells = [(arch, shp) for arch in ARCH_NAMES for shp in applicable_shapes(arch)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        if args.shape == "long_500k" and args.arch in LONG_CONTEXT_SKIP:
            print(f"SKIP {args.arch} x long_500k (pure full-attention)")
            return 0
        cells = [(args.arch, args.shape)]

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    ok, failed = 0, []
    for arch, shp in cells:
        for mp in meshes:
            tag = f"{arch}__{shp}__{'2x16x16' if mp else '16x16'}"
            try:
                cell_overrides = dict(overrides or {})
                if args.remat:
                    cell_overrides["remat"] = args.remat
                if args.qchunk:
                    cell_overrides["q_chunk"] = args.qchunk
                fsdp = not args.no_fsdp_data
                if args.serve_sharding and SHAPES[shp].kind == "decode":
                    # experts_only matters (and helps) only for MoE archs:
                    # non-MoE decode keeps full ZeRO-3 sharding
                    if get_config(arch).moe is not None or args.serve_sharding != "experts_only":
                        fsdp = {"experts_only": "experts_only", "full": True,
                                "model_only": False}[args.serve_sharding]
                rec = dry_cell(arch, shp, mp, fsdp_data=fsdp, n_microbatches=args.microbatches,
                               skip_segments=args.skip_segments, overrides=cell_overrides or None,
                               comm_fit=comm_fit, fabric=args.fabric)
                out = pathlib.Path(args.out) if args.out else RESULTS_DIR / f"{tag}.json"
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_text(json.dumps(rec, indent=1))
                print(f"  record: {out}")
                ok += 1
            except Exception as e:  # one failed cell must not stop --all
                failed.append((tag, repr(e)))
                print(f"FAILED {tag}: {e}")
                traceback.print_exc()
    print(f"\ndry-run complete: {ok} ok, {len(failed)} failed")
    for tag, err in failed:
        print(" FAIL:", tag, err[:200])
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
