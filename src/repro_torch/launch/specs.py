"""Meta-device stand-ins for every model input of every (arch, shape) cell
(counterpart of ``repro/launch/specs.py``): shapes and dtypes, no memory.

Where the JAX file returns ``jax.ShapeDtypeStruct`` trees, this one returns
the same trees of ``meta`` tensors.  ``param_specs`` is
``models.param_shapes`` (the stacked tree the sharding rules and the
planning layout read).  The JAX configs' ``chunk_impl`` and
``moe_token_chunk`` knobs, which ``arch_config_for_shape`` sets there, have
no use in the port: the port's attention loops over its query chunks in
Python (no ``lax.map`` / unroll choice), and no code reads a MoE token
chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs import get_config
from ..configs.shapes import SHAPES, ShapeSpec
from ..models.common import ArchConfig
from ..models.transformer import _flatten, init_caches, param_shapes
from ..optim.optimizers import OptState, Optimizer


def param_specs(cfg: ArchConfig) -> dict:
    return param_shapes(cfg)


def opt_state_specs(cfg: ArchConfig, optimizer: Optimizer) -> OptState:
    """The optimizer's state over ``param_specs``' tree: ``m`` / ``v`` trees
    of f32 meta tensors shaped like the parameters (empty trees where the
    optimizer keeps none, as SGD without momentum) and the step, an int32
    0-d meta tensor."""
    tree = param_specs(cfg)
    named = {".".join(path): leaf for path, leaf in _flatten(tree)}
    st = optimizer.init(named)

    def nest(flat: dict) -> dict:
        out: dict = {}
        for name, t in flat.items():
            node = out
            *head, last = name.split(".")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = t
        return out

    return OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                    m=nest(st.m), v=nest(st.v))


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    return init_caches(cfg, batch, max_seq, device="meta")


def batch_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Training / prefill inputs: tokens, or the stub frontends' bf16
    embeddings, and the targets."""
    B, S = shape.global_batch, shape.seq_len
    out = {"targets": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if cfg.input_mode == "embeds":
        out["embeds"] = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16, device="meta")
    else:
        out["tokens"] = torch.empty((B, S), dtype=torch.int32, device="meta")
    return out


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    B = shape.global_batch
    if cfg.input_mode == "embeds":
        return {"embeds": torch.empty((B, 1, cfg.d_model), dtype=torch.bfloat16, device="meta")}
    return {"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta")}


def moe_groups_for(rules, global_batch: int, seq_len: int, target_tg: int = 4096) -> int:
    """GShard group count: a multiple of the token-shard count keeping
    tokens-per-group near ``target_tg`` (the dispatch one-hot einsums cost
    2·T·E·C·D with C ∝ tg, so large groups make dispatch dominate expert
    compute; see models/moe.py)."""
    ba = rules.batch_axes(global_batch)
    shards = rules._axes_size(ba) if ba else 1
    tokens = global_batch * seq_len
    per_shard = tokens // shards
    m = max(1, per_shard // target_tg)
    while m > 1 and per_shard % m != 0:
        m -= 1
    return shards * m


def arch_config_for_shape(arch: str, shape_name: str, cost_mode: bool = False) -> ArchConfig:
    """The arch's config for one shape: query chunk 512 for training and
    2048 otherwise (at most the sequence), the recurrences' 128-step chunk,
    full remat for training and none for serving, and the plain attention
    (the JAX model never runs its Pallas attention in the dry run, and fake
    tensors cannot enter a kernel).  ``cost_mode`` is the segments'
    config: remat off, since the JAX segment counts hold no recompute."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    q_chunk = 512 if shape.kind == "train" else 2048
    overrides: dict[str, Any] = dict(
        q_chunk=min(q_chunk, shape.seq_len),
        rec_chunk=128,
        remat="full" if shape.kind == "train" and not cost_mode else "none",
        attn_impl="plain",
    )
    return dataclasses.replace(cfg, **overrides)
