"""Activation-sharding context (counterpart of ``repro/parallel/context.py``).

Model code is sharding-agnostic: the launcher activates a context and the
layers call ``constrain(x, {axis: role})`` at the tensor sites that matter
(projections, hidden states, dispatch buffers).  Roles:

  'batch'  : shard over the data axes (skipped when they do not divide,
             e.g. the batch-1 long_500k decode)
  'model'  : shard over the model axis, bound only under prefer='tp' or
             'seq_tp' (Megatron TP: MLP hidden, heads)
  'expert' : shard over the model axis whatever ``prefer`` says (EP: the
             expert dim of the MoE dispatch buffers follows the expert
             weights)
  'data'   : shard over the raw data axes (decode-EP shards the weights'
             contraction dims instead of gathering them)

``constrain`` is the identity without an active context and on a plain
tensor; on a DTensor under a context it redistributes to the placements
the roles give (``parallel.sharding.to_placements``), the counterpart of
``jax.lax.with_sharding_constraint``.  Off-context a site costs one
``ContextVar.get()``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

from .sharding import axes_entry, with_spec


@dataclasses.dataclass(frozen=True)
class ActSharding:
    batch_axes: tuple[str, ...] | None
    model_axis: str | None
    data_size: int
    model_size: int
    # the mesh's raw data axes (for 'data' contraction-dim roles: decode-EP
    # shards weight-contraction dims instead of gathering)
    data_axes: tuple[str, ...] | None = None
    raw_data_size: int = 1
    # 'fsdp':   only batch roles bind; weights are gathered per use.
    # 'tp':     'model' roles also bind (Megatron-style hidden / head sharding).
    # 'seq_tp': 'model' roles bind, and a self-attention prefill splits its
    #           query rows over the model axis (models.layers.gqa_attention).
    prefer: str = "fsdp"


_CTX: contextvars.ContextVar[ActSharding | None] = contextvars.ContextVar(
    "act_sharding", default=None
)


@contextlib.contextmanager
def activation_sharding(ctx: ActSharding | None):
    token = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(token)


def current() -> ActSharding | None:
    return _CTX.get()


def tp_active() -> bool:
    ctx = _CTX.get()
    return ctx is not None and ctx.prefer == "tp" and ctx.model_axis is not None


def tp_size() -> int:
    ctx = _CTX.get()
    return ctx.model_size if ctx is not None else 1


def role_spec(ctx: ActSharding, shape: tuple[int, ...], roles: dict[int, str]) -> tuple | None:
    """The spec that ``roles`` give a tensor of ``shape`` under ``ctx``, or
    None when no role binds (a dim a role's axes do not divide is left
    replicated, as in the JAX rules)."""
    spec: list = [None] * len(shape)
    used = False
    for ax, role in roles.items():
        dim = shape[ax]
        if role == "batch" and ctx.batch_axes and dim % ctx.data_size == 0:
            spec[ax] = axes_entry(ctx.batch_axes)
            used = True
        elif (role == "model" and ctx.prefer in ("tp", "seq_tp") and ctx.model_axis
              and dim % ctx.model_size == 0):
            spec[ax] = ctx.model_axis
            used = True
        elif role == "expert" and ctx.model_axis and dim % ctx.model_size == 0:
            spec[ax] = ctx.model_axis
            used = True
        elif role == "data" and ctx.data_axes and dim % ctx.raw_data_size == 0:
            spec[ax] = axes_entry(ctx.data_axes)
            used = True
    return tuple(spec) if used else None


def constrain(x, roles: dict[int, str]):
    """``x`` redistributed to the placements its axis roles give (see the
    module docstring); the identity when no context is active, on a plain
    tensor, or when nothing divides."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    spec = role_spec(ctx, tuple(x.shape), roles)
    return x if spec is None else with_spec(x, spec)


def from_rules(rules, batch: int, prefer: str = "fsdp") -> ActSharding:
    """The context of ``ShardingRules`` for a given global batch."""
    ba = rules.batch_axes(batch)
    size = 1
    if ba:
        for a in ba:
            size *= rules.mesh_shape[a]
    model_ax = rules.model_axis if (not ba or rules.model_axis not in ba) else None
    return ActSharding(
        batch_axes=ba,
        model_axis=model_ax,
        data_size=size if ba else rules.data_size,
        model_size=rules.model_size,
        prefer=prefer,
        data_axes=rules.data_axes,
        raw_data_size=rules.data_size,
    )
