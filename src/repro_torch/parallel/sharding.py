"""Sharding rules: DP / FSDP / TP / EP / SP as partition specs (counterpart
of ``repro/parallel/sharding.py``).

A spec is the JAX ``PartitionSpec`` as a plain tuple: one entry per tensor
dim, each ``None`` (replicated), a mesh axis name, or a tuple of two or more
axis names (the dim split over several axes, the first one major; one axis
is written as its name, as ``PartitionSpec`` normalizes it); ``()``
replicates a tensor of any rank.  ``to_placements`` turns a spec into the DTensor
``Shard`` / ``Replicate`` placements of a ``DeviceMesh`` with named dims,
the counterpart of the JAX ``named``.

Axes
----
``('data', 'model')`` single-pod, ``('pod', 'data', 'model')`` multi-pod.
The batch shards over the data axes; parameters shard FSDP-style:

  * the largest weight dim divisible by |model| shards over ``'model'``
    (expert-stacked weights prefer the expert dim, true EP, when it
    divides: dbrx's 16 experts on a 16-way model axis);
  * with ``fsdp_data=True`` a second dim shards over the data axes,
    ZeRO-3 style.  The paper-faithful baseline (``False``) keeps the
    parameters replicated across data, so the gradient synchronization is
    a pure all-reduce, the operation MG-WFBP schedules.

KV caches shard the batch over data when it divides, else the sequence
(SP: the batch-1 long_500k regime), and the sequence over ``'model'``.

Nothing here imports the models: the rules read only ``cfg.moe``,
``cfg.vocab`` and ``cfg.input_mode`` of the config they are given.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

import torch

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

    from ..models.common import ArchConfig

Spec = tuple  # one entry per tensor dim: None | axis name | tuple of axis names

MOE_LEAF_NAMES = ("w_gate", "w_up", "w_down")


def axes_entry(axes: tuple[str, ...] | None):
    """A spec entry for a tuple of axes: None, the name of a single axis,
    or the tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolved sharding policy for one (arch, mesh) pair."""

    data_axes: tuple[str, ...]
    model_axis: str
    mesh_shape: dict[str, int]
    # False: params sharded over 'model' only (paper-faithful: DP grads are
    #        pure all-reduces).  True: second dim over the data axes
    #        (ZeRO-3).  'experts_only': serving mode, dense weights stay
    #        model-only while the big expert tables keep the data dim.
    fsdp_data: bool | str = False
    # EP archs reserve the model axis for experts: the batch must not
    # shard over it (the MoE all-to-all runs G@data <-> E@model).
    reserve_model: bool = False

    @property
    def data_size(self) -> int:
        return self._axes_size(self.data_axes)

    @property
    def model_size(self) -> int:
        return self.mesh_shape[self.model_axis]

    def _axes_size(self, axes: tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.mesh_shape[a]
        return n

    def batch_axes(self, batch: int) -> tuple[str, ...] | None:
        """The largest mesh-axis combination that divides the batch.

        train_4k's 256 rows are one pod's 256 ranks, so the batch shards
        over every axis (pure 256-way DP; ZeRO-3 gathers the FSDP weights).
        Smaller batches fall back to fewer axes; a batch-1 decode returns
        None and the sequence-parallel cache sharding carries the
        parallelism instead."""
        candidates = [
            self.data_axes + (self.model_axis,),
            self.data_axes,
            self.data_axes[-1:],
        ]
        if self.reserve_model:
            candidates = candidates[1:]
        for axes in candidates:
            if axes and batch % self._axes_size(axes) == 0:
                return axes
        return None


def rules_for_mesh(mesh: DeviceMesh, fsdp_data: bool | str = False) -> ShardingRules:
    """The rules of a mesh with named dims: every dim but ``'model'`` is a
    data axis."""
    names = tuple(mesh.mesh_dim_names)
    shape = dict(zip(names, mesh.mesh.shape))
    data_axes = tuple(a for a in names if a != "model")
    return ShardingRules(
        data_axes=data_axes, model_axis="model",
        mesh_shape={k: int(v) for k, v in shape.items()}, fsdp_data=fsdp_data,
    )


def rules_for_arch(cfg: ArchConfig, mesh: DeviceMesh, fsdp_data: bool | str = False) -> ShardingRules:
    """Arch-aware rules: EP archs reserve the model axis for experts."""
    rules = rules_for_mesh(mesh, fsdp_data)
    ep = cfg.moe is not None and cfg.moe.n_experts % rules.model_size == 0
    return dataclasses.replace(rules, reserve_model=ep)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _leaf_spec(path_names: list[str], shape: tuple[int, ...], rules: ShardingRules) -> Spec:
    """FSDP spec for one parameter leaf."""
    in_stages = "stages" in path_names
    dims = list(enumerate(shape))
    if in_stages:
        dims = dims[1:]  # the leading n_stages axis stays replicated
    if len(dims) < 2:
        return ()  # 1-D (norm scales, biases, lambdas): replicate

    spec: list[Any] = [None] * len(shape)
    # as in the JAX rules, any leaf named w_gate / w_up / w_down counts,
    # the dense MLP's too: its first non-stage dim is tried first
    is_moe = any(n in MOE_LEAF_NAMES for n in path_names)
    model_dim = None
    if is_moe:
        e_axis, e_size = dims[0]
        if e_size % rules.model_size == 0:
            model_dim = e_axis
    if model_dim is None:
        for ax, size in sorted(dims, key=lambda t: -t[1]):
            if size % rules.model_size == 0:
                model_dim = ax
                break
    if model_dim is not None:
        spec[model_dim] = rules.model_axis

    want_data = rules.fsdp_data is True or (rules.fsdp_data == "experts_only" and is_moe)
    if want_data:
        for ax, size in sorted(dims, key=lambda t: -t[1]):
            if ax != model_dim and size % rules.data_size == 0:
                spec[ax] = axes_entry(rules.data_axes)
                break
    return tuple(spec)


def _map_with_path(fn, tree: Any, path: tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(list(path), tree)


def is_spec(x: Any) -> bool:
    """Whether ``x`` is a spec (a tuple of None, axis names and tuples of
    axis names), not a tuple of specs."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e)) for e in x)


def param_pspecs(param_shapes: Any, rules: ShardingRules) -> Any:
    """A spec for every leaf of a stacked shape tree (``models.param_shapes``),
    in the tree's structure."""
    return _map_with_path(lambda names, leaf: _leaf_spec(names, tuple(leaf.shape), rules),
                          param_shapes)


# ---------------------------------------------------------------------------
# Activations / batch / caches
# ---------------------------------------------------------------------------


def batch_specs(cfg: ArchConfig, rules: ShardingRules, batch: int, seq: int) -> dict:
    ba = axes_entry(rules.batch_axes(batch))
    out = {"targets": (ba, None)}
    if cfg.input_mode == "embeds":
        out["embeds"] = (ba, None, None)
    else:
        out["tokens"] = (ba, None)
    return out


def act_constraint(cfg: ArchConfig, rules: ShardingRules, batch: int):
    """Between-stage activation constraint: batch over the data axes (the
    identity on a plain tensor, as ``parallel.context.constrain``)."""
    ba = axes_entry(rules.batch_axes(batch))

    def constrain(x):
        if ba is None:
            return x
        return with_spec(x, (ba, None, None))

    return constrain


def logits_constraint(cfg: ArchConfig, rules: ShardingRules, batch: int):
    """The logits (B, S, vocab): batch over its axes, vocab over ``'model'``
    when it divides and the batch left the model axis free."""
    ba = rules.batch_axes(batch)
    vocab_ax = rules.model_axis if cfg.vocab % rules.model_size == 0 else None
    if ba and rules.model_axis in ba:
        vocab_ax = None  # model axis already consumed by the batch
    spec = (axes_entry(ba), None, vocab_ax)

    def constrain(x):
        return with_spec(x, spec)

    return constrain


def cache_pspecs(cfg: ArchConfig, rules: ShardingRules, cache_shapes: Any, batch: int) -> Any:
    """Decode cache specs, in the cache tree's structure.

    KV leaves are (n_stages?, B, T, Hkv, hd) (+ kpos (n_stages?, T));
    recurrent states are (n_stages?, B, ...).  The batch shards over data
    when it divides.  The KV *sequence* axis shards over ``'model'``
    (flash-decoding style); a recurrent state's width shards over
    ``'model'``."""
    ba = rules.batch_axes(batch)
    if ba and rules.model_axis in ba:
        ba = tuple(a for a in ba if a != rules.model_axis) or None
    ba_size = rules._axes_size(ba) if ba else 0

    def spec(names, leaf):
        shape = tuple(leaf.shape)
        staged = "stages" in names
        body = shape[1:] if staged else shape
        lead: list[Any] = [None] if staged else []
        if len(body) == 1:  # kpos (T,): replicated with the seq shards
            return (*lead, None)
        s: list[Any] = [None] * len(body)
        if ba and body[0] % ba_size == 0:
            s[0] = axes_entry(ba)
        if len(body) >= 3:
            # KV cache (B, T, Hkv, hd) or wkv state (B, H, K, K): axis 1 over model
            if body[1] % rules.model_size == 0:
                s[1] = rules.model_axis
        elif len(body) == 2 and body[-1] % rules.model_size == 0:
            s[-1] = rules.model_axis  # (B, W) recurrent state: width over model
        return (*lead, *s)

    return _map_with_path(spec, cache_shapes)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------


def to_placements(spec: Spec, mesh: DeviceMesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` names, else
    ``Replicate()``.

    A tensor dim over several axes (``('pod', 'data')``, ``('data',
    'model')``) splits over them major to minor in the spec's order, as
    JAX splits it; DTensor splits such a dim in mesh-dim order.  The two
    agree when the spec lists the axes in mesh order, which every spec of
    these rules does (the data axes are the mesh's, in its order, and
    ``'model'`` is its last dim); any other order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} lists {axes} out of the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} used twice")
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a plain tensor answers without importing
    ``torch.distributed.tensor``)."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def with_spec(x, spec: Spec):
    """``x`` redistributed to ``spec``'s placements on its mesh when it is a
    DTensor (the counterpart of ``jax.lax.with_sharding_constraint``);
    a plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def on_local_shards(fn, ref, args: tuple, arg_dims: tuple, out_dims: tuple, whole: tuple = (1,)):
    """``fn(*args)`` on each rank's local shards: a ``local_map`` region, for
    an op DTensor has no sharding strategy for (a recurrence over time, a
    kernel).  ``ref``'s placements name the sharded dims: ``arg_dims`` /
    ``out_dims`` give, for each argument and output, the dim of ``ref``
    each of its dims is (None: none).  A ``ref`` dim in ``whole`` (time,
    by default) and anything but a plain shard are gathered first; every
    other shard of ``ref`` carries over."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def placements(dims):
        out = []
        for p in ref.placements:
            d = p.dim if type(p) is Shard else None
            out.append(Shard(dims.index(d)) if d is not None and d not in whole and d in dims
                       else Replicate())
        return tuple(out)

    region = local_map(
        fn,
        out_placements=tuple(placements(d) for d in out_dims),
        in_placements=tuple(None if a is None else placements(d) for a, d in zip(args, arg_dims)),
        device_mesh=ref.device_mesh,
        redistribute_inputs=True,
    )
    return region(*args)
