"""Mapping between model parameters and schedule buckets (counterpart of
``repro/core/bucketing.py``).

The scheduler works on the paper's flat layer list ``1..L``.  The layout
names every communication unit in backward-availability order over a
*shape tree*: a nested dict whose paths are the JAX package's parameter
paths (``('embed',)``, ``('stages', 'attn_0', 'attn', 'wq')``, ...), with
the ``stages`` leaves stacked on a leading ``n_stages`` axis.  The port's
model keeps one module per layer (``stages.<i>.attn_0.attn.wq``), so the
wire plan is resolved to parameter names by ``entry_param_names``: a slice
entry ``(path, (a, b))`` becomes the parts ``stages.a.<path>`` ...
``stages.<b-1>.<path>`` in order, whose concatenation is exactly the
stacked ``leaf[a:b].reshape(-1)`` of the reference.

Leaves are visited in sorted key order at every dict level, as
``jax.tree_util`` flattens dicts: arena offsets depend on that order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from .schedule import Schedule

LEAF = "leaf"
STACKED = "stacked"

#: Bytes per element of the wire dtypes, by name (numpy does not know
#: ``bfloat16``).
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def dtype_name(dtype: Any) -> str:
    """'float32' / 'bfloat16' for a torch dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def tree_get(tree: Any, path: tuple[Any, ...]) -> Any:
    """Indexed lookup on nested dict/list trees."""
    for p in path:
        tree = tree[p]
    return tree


@dataclasses.dataclass(frozen=True)
class CommUnit:
    """One schedulable gradient message (paper: one 'layer' l with p^(l))."""

    name: str
    index: int  # 1-based position in backward-forward layer order
    grad_bytes: int
    params: int
    # paths into the shape tree whose leaves belong to this unit
    # (kind == 'stacked': the stacked leaves, sliced at stack_index)
    paths: tuple[tuple[Any, ...], ...]
    kind: str = LEAF
    stack_index: int = -1


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Ordered communication units; ``units[0]`` is layer 1 in the paper's
    numbering (the first forward layer, whose gradient lands last)."""

    units: tuple[CommUnit, ...]

    @property
    def num_layers(self) -> int:
        return len(self.units)


def _subtree_paths(tree: Any, prefix: tuple[Any, ...]) -> list[tuple[tuple[Any, ...], Any]]:
    """(full path, leaf) pairs under ``tree``, dict keys in sorted order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_subtree_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def _leaf_size(leaf: Any) -> int:
    n = 1
    for d in getattr(leaf, "shape", ()):
        n *= int(d)
    return n


def tree_size(tree: Any) -> int:
    return sum(_leaf_size(leaf) for _, leaf in _subtree_paths(tree, ()))


def layout_from_params(
    params: Any,
    comm_dtype_bytes: int = 4,
    model_shards: int = 1,
    order_key: Callable[[str], float] | None = None,
) -> ParamLayout:
    """A per-leaf ParamLayout of a parameter tree: one unit per leaf.

    ``params`` is a nested dict of tensors (or of anything with a
    ``shape``), visited in sorted key order as the JAX tree is, each leaf
    named by its dot-joined path; or an ``nn.Module``, whose
    ``named_parameters()`` give the leaves in registration order, each
    path the name split at its dots.  Leaves are ordered by ``order_key``
    over their names (default: that order).  ``model_shards`` divides the
    data-parallel message size (FSDP / TP / EP shrink its payload)."""
    if isinstance(params, nn.Module):
        named = [(name, tuple(name.split(".")), p) for name, p in params.named_parameters()]
    else:
        named = [(".".join(map(str, path)), path, leaf)
                 for path, leaf in _subtree_paths(params, ())]
    if order_key is not None:
        named.sort(key=lambda t: order_key(t[0]))
    units = []
    for i, (name, path, leaf) in enumerate(named):
        size = _leaf_size(leaf)
        units.append(CommUnit(name=name, index=i + 1,
                              grad_bytes=max(1, size * comm_dtype_bytes // model_shards),
                              params=size, paths=(path,)))
    return ParamLayout(units=tuple(units))


def stacked_lm_layout(
    param_shapes: Any,
    n_stages: int,
    comm_dtype_bytes: int = 4,
    model_shards: int = 1,
) -> ParamLayout:
    """ParamLayout for the stacked LM shape tree.

    Units in paper order (gradient of unit 1 lands last):
      unit 1             = embed                       (leaf kind)
      units 2..n+1       = stages                      (stacked kind)
      unit n+2 (if tail) = tail stage                  (leaf kind)
      last unit          = head + final_norm           (leaf kind)
    """

    def leaf_unit(name: str, idx: int, pairs) -> CommUnit:
        size = sum(_leaf_size(leaf) for _, leaf in pairs)
        return CommUnit(
            name=name, index=idx,
            grad_bytes=max(1, size * comm_dtype_bytes // model_shards),
            params=size, paths=tuple(p for p, _ in pairs),
        )

    units = [leaf_unit("embed", 1, _subtree_paths(param_shapes["embed"], ("embed",)))]
    stage_pairs = _subtree_paths(param_shapes["stages"], ("stages",))
    stage_params = sum(_leaf_size(leaf) for _, leaf in stage_pairs) // n_stages
    stage_paths = tuple(p for p, _ in stage_pairs)
    for i in range(n_stages):
        units.append(
            CommUnit(
                name=f"stage_{i}", index=i + 2,
                grad_bytes=max(1, stage_params * comm_dtype_bytes // model_shards),
                params=stage_params, paths=stage_paths,
                kind=STACKED, stack_index=i,
            )
        )
    idx = n_stages + 2
    if "tail" in param_shapes:
        units.append(leaf_unit("tail", idx, _subtree_paths(param_shapes["tail"], ("tail",))))
        idx += 1
    head_pairs = _subtree_paths(param_shapes["final_norm"], ("final_norm",))
    if "head" in param_shapes:
        head_pairs += _subtree_paths(param_shapes["head"], ("head",))
    units.append(leaf_unit("head", idx, head_pairs))
    return ParamLayout(units=tuple(units))


def layout_for_stacked_lm(
    num_layers: int,
    embed_params: int,
    layer_params: int,
    head_params: int,
    comm_dtype_bytes: int = 4,
    model_shards: int = 1,
) -> ParamLayout:
    """A synthetic ParamLayout of a stacked LM, ``[embed, layer x L, head]``,
    for the cost model alone (no tree behind it; ``stacked_lm_layout`` is
    the one the sync runs on)."""

    def unit(name: str, idx: int, p: int) -> CommUnit:
        return CommUnit(name=name, index=idx,
                        grad_bytes=max(1, p * comm_dtype_bytes // model_shards),
                        params=p, paths=((name,),))

    units = [unit("embed", 1, embed_params)]
    units += [unit(f"layer_{i}", i + 2, layer_params) for i in range(num_layers)]
    units += [unit("head", num_layers + 2, head_params)]
    return ParamLayout(units=tuple(units))


def bucket_assignment(layout: ParamLayout, schedule: Schedule) -> list[list[CommUnit]]:
    """Units grouped per schedule group, ascending (layer-1 group first)."""
    if schedule.num_layers != layout.num_layers:
        raise ValueError(
            f"schedule covers {schedule.num_layers} layers, layout has {layout.num_layers}"
        )
    return [[layout.units[i - 1] for i in range(lo, hi + 1)] for lo, hi in schedule.groups]


# One wire entry: ('leaf', path, None) or ('slice', path, (a, b)).
WireEntry = tuple[str, tuple[Any, ...], tuple[int, int] | None]


def wire_entries(layout: ParamLayout, schedule: Schedule) -> list[list[WireEntry]]:
    """Per-group wire plan in backward issue order (layer-L group first).

    Leaf units contribute one entry per leaf path; contiguous stacked
    units collapse into one ``[a:b)`` slice entry per stacked leaf path.
    """
    groups: list[list[WireEntry]] = []
    for units in reversed(bucket_assignment(layout, schedule)):
        entries: list[WireEntry] = []
        runs: dict[tuple, list[int]] = {}
        for u in units:
            if u.kind == LEAF:
                entries.extend(("leaf", p, None) for p in u.paths)
            else:
                runs.setdefault(u.paths, []).append(u.stack_index)
        for paths, idxs in runs.items():
            a, b = min(idxs), max(idxs) + 1
            if sorted(idxs) != list(range(a, b)):
                raise ValueError(f"stacked units in one group must be contiguous: {idxs}")
            entries.extend(("slice", p, (a, b)) for p in paths)
        groups.append(entries)
    return groups


def entry_param_names(entry: WireEntry) -> list[str]:
    """Module parameter names of one wire entry, in wire order.

    A leaf path joins with dots (``('final_norm', 'scale')`` ->
    ``final_norm.scale``); a slice over the stacked subtree ``stages``
    names one parameter per layer of ``[a, b)``.
    """
    kind, path, ab = entry
    if kind == "leaf":
        return [".".join(map(str, path))]
    rest = ".".join(map(str, path[1:]))
    return [f"{path[0]}.{j}.{rest}" for j in range(ab[0], ab[1])]


@dataclasses.dataclass(frozen=True)
class ArenaSlot:
    """One wire entry's span inside its group's flat arena."""

    kind: str  # 'leaf' | 'slice'
    path: tuple[Any, ...]
    stack_range: tuple[int, int] | None  # [a, b) over the stacked axis
    offset: int  # element offset into the arena
    size: int  # elements
    shape: tuple[int, ...]  # shape of the packed value


@dataclasses.dataclass(frozen=True)
class GroupArena:
    """Flat wire layout of one schedule group, exact-packed (no padding)."""

    slots: tuple[ArenaSlot, ...]
    size: int  # total elements
    comm_dtype: str

    @property
    def nbytes(self) -> int:
        return self.size * DTYPE_BYTES[self.comm_dtype]


def group_arenas(
    layout: ParamLayout,
    schedule: Schedule,
    shapes: Any,
    comm_dtype: Any = "float32",
) -> list[GroupArena]:
    """Plan-time arena layouts, one per schedule group (backward order).

    ``shapes`` is the shape tree (leaves with ``.shape``) or a callable
    ``path -> shape``.
    """
    if callable(shapes):
        shape_of = shapes
    else:
        def shape_of(p):
            shape = getattr(tree_get(shapes, p), "shape", None)
            if shape is None:
                raise TypeError(f"leaf at {p} has no .shape; pass tensors or a path->shape callable")
            return tuple(shape)
    arenas = []
    for entries in wire_entries(layout, schedule):
        slots, off = [], 0
        for kind, path, ab in entries:
            shape = tuple(int(d) for d in shape_of(path))
            if kind == "slice":
                shape = (ab[1] - ab[0],) + shape[1:]
            n = 1
            for d in shape:
                n *= d
            slots.append(ArenaSlot(kind=kind, path=path, stack_range=ab,
                                   offset=off, size=n, shape=shape))
            off += n
        arenas.append(GroupArena(slots=tuple(slots), size=off, comm_dtype=dtype_name(comm_dtype)))
    return arenas


def layer_buckets_for_scan(schedule: Schedule, num_scan_layers: int) -> tuple[tuple[int, int], ...]:
    """Translate an [embed, L layers, head] schedule into stage segments."""
    segs = []
    for lo, hi in schedule.groups:
        # schedule indices: 1 = embed, 2..L+1 = layers, L+2 = head
        start = max(lo - 2, 0)
        stop = min(hi - 1, num_scan_layers)
        if stop > start:
            segs.append((start, stop))
    covered = sum(b - a for a, b in segs)
    if covered != num_scan_layers:
        raise ValueError(f"scan segments {segs} do not cover {num_scan_layers} layers")
    return tuple(segs)
