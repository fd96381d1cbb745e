"""Segment cost accounting on a fake world (counterpart of
``repro/launch/segments.py``).

The JAX file lowers one stage (and the head) with production shardings and
reads XLA's ``cost_analysis()`` and the collectives in the HLO.  Here the
same segments run once on fake DTensors: a fake process group of 256 / 512
ranks (``fake_world``), a ``DeviceMesh`` over it, and every parameter and
input a DTensor whose local shard is a ``meta`` tensor, placed by
``parallel.sharding``.  Nothing is allocated or computed; ``CostMode`` reads
what each op would do on one rank:

* **flops per device**: each op's global flops (``torch.utils.flop_counter``'s
  formulas, matmul-class ops only) divided by the product of the sizes of
  the mesh dims on which the op's output is not ``Replicate`` (a shard,
  strided or plain, or a partial sum); on a ``Replicate`` dim every rank
  does the work again.  XLA's count also holds
  the elementwise flops, so the port's count is the smaller (0.87-0.99 of
  it on the reduced and full configs);
* **bytes per device**: the local bytes of each op's tensor inputs and
  outputs (view ops move nothing and are skipped).  These are unfused
  bytes, larger than XLA's fused count;
* **collectives**: each redistribution DTensor runs, counted by the
  placement rule (``_redistributions_counted``: one collective per mesh
  dim whose placement changes, by the JAX kind names ``all-gather``,
  ``reduce-scatter``, ``all-reduce``, ``all-to-all``), its payload the
  larger of its local input and output bytes (the JAX parser's rule), not
  by the collectives DTensor's planner executes, which differ between
  torch versions; a ``c10d_functional`` collective issued outside a
  redistribution counts as executed.  GSPMD also issues
  ``collective-permute``s and involuntary rematerializations that DTensor
  does not, so the two records agree by kind and rule, not by bytes.

Where DTensor's sharding propagation would place a result otherwise than
GSPMD, or differently in different torch versions, ``CostMode`` and
``counting`` place it as GSPMD does: an op linear in a partial sum (a sum of
partial sums, a product by a replicated factor) keeps it partial
(``_partial_linear``); any other elementwise op's partial operand is
reduced first, by one rule (``_reduce_partials``); operands of an
elementwise op take one layout (``_align_pointwise``); a ``bmm`` is placed
by rule on each rank's shards (``_placed_bmm``: the local attention's
products); and the MoE combine runs on each rank's experts
(``_ShardedCombine``).  So no partial sum reaches DTensor's own propagation
as an operand of an elementwise op or of a ``bmm`` it places, and torch
2.11 and 2.13 give the same records.

A segment counts with remat off (``specs.arch_config_for_shape(...,
cost_mode=True)``): the JAX segment count holds no recompute.  A train
segment returns its weight gradients in their parameters' placements (the
FSDP reduce-scatter, or the DP all-reduce over replicated data axes).
All numbers are per device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..models.common import ArchConfig
from ..models.layers import make_norm, softcap_logits
from ..models.transformer import _sublayers, run_sublayer
from ..parallel.context import activation_sharding, from_rules
from ..parallel.sharding import ShardingRules, batch_specs, param_pspecs, to_placements, with_spec
from .specs import param_specs

# c10d functional op -> the JAX parser's kind name
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


@dataclasses.dataclass
class SegCost:
    name: str
    flops: float
    bytes_accessed: float
    coll_counts: dict[str, int]
    coll_bytes: dict[str, int]

    @property
    def coll_total_bytes(self) -> int:
        return sum(self.coll_bytes.values())


# ---------------------------------------------------------------------------
# The fake world and fake DTensors
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0: collectives return at once and move nothing.  Destroyed on
    exit, so a later real group (``ProcessWorld``, gloo) is not joined to
    it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the fake world needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A ``DeviceMesh`` with named dims over the fake world's ranks (CPU
    device type; the local shards are ``meta`` tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


@contextlib.contextmanager
def fake_tensors():
    """``FakeTensorMode`` for one rank's plain (non-DTensor) segment.  The
    models keep per-device constants in caches (rotary frequencies, the
    sinusoid table, 0-d scalars); they are emptied on entry and on exit, so
    no real tensor enters the fake region and no fake one outlives it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import layers, transformer

    caches = (layers._rope_freqs_on, layers._mrope_freqs_on, layers.sinusoidal_embedding,
              transformer._constant)
    for c in caches:
        c.cache_clear()
    try:
        with FakeTensorMode():
            yield
    finally:
        for c in caches:
            c.cache_clear()


def contiguous_stride(shape: tuple[int, ...]) -> tuple[int, ...]:
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


def local_shape(shape: tuple[int, ...], placements, mesh) -> tuple[int, ...]:
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            if out[p.dim] % mesh.size(i):
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split {mesh.size(i)} ways")
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def fake_dtensor(shape: tuple[int, ...], dtype: torch.dtype, spec, mesh,
                 fill: Callable[[tuple[int, ...]], torch.Tensor] | None = None):
    """A DTensor of global ``shape`` placed by ``spec`` on ``mesh``, its
    local shard a ``meta`` tensor: shape and dtype, no memory, no compute
    (``fill(local shape)``, moved to ``meta``, when its values matter to a
    shape: positions).  DTensor's sharding propagation then runs under a
    fake mode of its own, which ``MemTracker`` tells apart from the local
    ops (it counts these only)."""
    from torch.distributed.tensor import DTensor

    placements = to_placements(spec, mesh)
    loc = local_shape(tuple(shape), placements, mesh)
    local = (fill(loc) if fill is not None else torch.empty(loc, dtype=dtype)).to("meta")
    stride = contiguous_stride(tuple(shape))
    return DTensor.from_local(local.to(dtype), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _reshard(x, placements):
    """``x`` redistributed from inside ``CostMode`` (below autograd, which
    records nothing there): detached first, so no output of DTensor's
    autograd function needs an in-place detach, which DTensor has no
    strategy for."""
    return x.detach().redistribute(x.device_mesh, placements)


def _at_use(p):
    """ZeRO-3 at use: under an activation-sharding context, a parameter is
    all-gathered over every mesh axis the batch is sharded over (where the
    step cannot compute on the parameter's shard), as GSPMD gathers the
    FSDP weights; the step reduce-scatters its gradient back to the stored
    shards (``launch.steps``).  A shard on an axis the batch leaves free
    stays (model-parallel compute), and so do all the shards of a
    parameter marked ``keep_shards`` (the serving rules' EP expert
    tables).  Off-context, the stored parameter."""
    from torch.distributed.tensor import Replicate

    from ..parallel.context import current

    ctx = current()
    if ctx is None or not ctx.batch_axes or getattr(p, "keep_shards", False):
        return p
    names = p.device_mesh.mesh_dim_names
    placements = tuple(Replicate() if pl.is_shard() and names[i] in ctx.batch_axes else pl
                       for i, pl in enumerate(p.placements))
    if placements == tuple(p.placements):
        return p
    return _reshard(p, placements)


def distribute_module(module: nn.Module, spec_of: Callable[[str], tuple], mesh,
                      keep_experts: bool = False) -> nn.Module:
    """Every parameter of ``module`` (meta) replaced by a fake DTensor
    parameter of the same shape and dtype, placed by ``spec_of(name)``;
    ``CostMode`` gathers each where it is used (``_at_use``), except the
    MoE expert tables under ``keep_experts`` (consumed shard-local: the
    serving rules' decode-EP)."""
    for mod_name, mod in list(module.named_modules()):
        for name, p in list(mod.named_parameters(recurse=False)):
            full = f"{mod_name}.{name}" if mod_name else name
            dt = fake_dtensor(tuple(p.shape), p.dtype, spec_of(full), mesh)
            param = nn.Parameter(dt, requires_grad=p.requires_grad)
            if keep_experts and mod_name.split(".")[-1] == "moe" and name in ("w_gate", "w_up", "w_down"):
                param.keep_shards = True
            setattr(mod, name, param)
    return module


def distribute_tree(tree: Any, specs: Any, mesh, dtype: torch.dtype | None = None) -> Any:
    """A tree of meta tensors (dicts, tuples) as fake DTensors placed by
    the matching tree of specs, in ``dtype`` when given."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(distribute_tree(v, s, mesh, dtype) for v, s in zip(tree, specs))
    return fake_dtensor(tuple(tree.shape), dtype or tree.dtype, specs, mesh)


def local_nbytes(tree: Any) -> int:
    """Bytes of the local shards (of the tensors themselves for plain
    tensors) of every tensor in a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return sum(local_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(local_nbytes(v) for v in tree)
    return _local_nbytes(tree) if isinstance(tree, torch.Tensor) else 0


def tree_get(tree: dict, path: list[str]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _local_nbytes(t: torch.Tensor) -> int:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------


class _Tally:
    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_counts: dict[str, int] = {}
        self.coll_bytes: dict[str, int] = {}
        self.concat_ops = 0
        # each collective by the op that issued it: "<kind> <- <DTensor op>"
        self.coll_by_op: dict[str, int] = {}
        self.op: str = "outside an op"

    def collective(self, func, args, out) -> bool:
        if func.namespace != "_c10d_functional":
            return False
        kind = COLLECTIVE_KINDS.get(func._overloadpacket.__name__)
        if kind is not None:
            ins = [a for a in tree_flatten(args)[0] if isinstance(a, torch.Tensor)]
            outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
            self.count(kind, max(sum(map(_local_nbytes, ins)), sum(map(_local_nbytes, outs))))
        return True

    def count(self, kind: str, nbytes: int) -> None:
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + nbytes
        key = f"{kind} <- {self.op}"
        self.coll_by_op[key] = self.coll_by_op.get(key, 0) + 1

    def seg_cost(self, name: str) -> SegCost:
        return SegCost(name=name, flops=self.flops, bytes_accessed=self.bytes,
                       coll_counts=dict(self.coll_counts), coll_bytes=dict(self.coll_bytes))


class _CollectiveMode(TorchDispatchMode):
    """Sees the local ops a DTensor op dispatches to (it lets the DTensor
    run first, as ``CommDebugMode`` does) and counts their collectives."""

    def __init__(self, tally: _Tally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            if func._overloadpacket is torch.ops.aten._assert_async:
                return None  # a decomposition's check (one_hot's): no strategy, no result
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.tally.collective(func, args, out)
        return out


class CostMode(TorchDispatchMode):
    """Per-device flops, bytes and collectives of everything run under it
    (see the module docstring).  A DTensor op counts by the placement rule;
    a plain-tensor op (a redistribution's local work, or code on local
    shards) counts as it is, per device."""

    def __init__(self):
        super().__init__()
        self.tally = _Tally()
        self._inner = _CollectiveMode(self.tally)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        tally = self.tally
        if func._overloadpacket in _NEW_TENSOR_OPS and isinstance(args[0], DTensor):
            return _new_like_shards(func, args, kwargs)
        if func is torch.ops.aten.expand.default and _is_replicated_scalar(args[0]):
            out = _expand_over_batch(args[0], tuple(args[1]))
            if out is not None:
                return out
        out = _partial_linear(func, args, kwargs)
        if out is not None:
            outs = [out]
        elif any(issubclass(t, DTensor) for t in types):
            outer, tally.op = tally.op, str(func)
            with self._inner:
                args = tuple(_at_use(a) if isinstance(a, nn.Parameter) else a for a in args)
                if torch.Tag.pointwise in func.tags:
                    args = _align_pointwise(_reduce_partials(args))
                placed = _placed_bmm(args) if func is torch.ops.aten.bmm.default else None
                try:
                    out = func(*args, **kwargs) if placed is None else placed[1]
                except RuntimeError:
                    if not _is_view(func) or not isinstance(args[0], DTensor):
                        raise
                    out = _split_view(args[0], tuple(args[1]))
                    if out is None:
                        out = func(_unsharded_past_prefix(args[0], args[1]), *args[1:], **kwargs)
                if isinstance(out, DTensor) and any(_is_mask_partial(p) for p in out.placements):
                    out = _reduce_mask_partial(out)
            tally.op = outer
            outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
            if func._overloadpacket in flop_registry:
                flops = flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
                # a placed product counts where it was computed, before its reduction
                d = placed[0] if placed is not None else \
                    next((o for o in outs if isinstance(o, DTensor)), None)
                div = 1
                if d is not None:
                    div = math.prod(d.device_mesh.size(i) for i, p in enumerate(d.placements)
                                    if not p.is_replicate())
                tally.flops += flops / div
        else:
            out = func(*args, **kwargs)
            if tally.collective(func, args, out):
                return out
            outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
            if func._overloadpacket in flop_registry:
                tally.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        if func._overloadpacket is torch.ops.aten.cat:
            tally.concat_ops += 1
        if not func.is_view:
            ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
            tally.bytes += sum(map(_local_nbytes, ins)) + sum(map(_local_nbytes, outs))
        return out


_LINEAR_OPS = (torch.ops.aten.add, torch.ops.aten.sub)


def _is_partial_sum(x) -> bool:
    """A DTensor with a partial sum (or mean) on some mesh dim, and no other
    kind of partial."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or any(_is_mask_partial(p) for p in x.placements):
        return False
    partial = [p for p in x.placements if p.is_partial()]
    return bool(partial) and all(p.reduce_op in ("sum", "avg") for p in partial)


def _partial_linear(func, args, kwargs):
    """An op linear in a partial sum keeps it partial, on each rank's
    shards, with no collective, whatever DTensor's own rule (which depends
    on the torch version: 2.11 all-reduces the partial operand of such a
    sum or product, 2.13 keeps it):

    * a sum or difference of two DTensors of one shape whose placements
      agree on every mesh dim, or are a partial sum on one side and
      replicated on the other (the replicated operand counts once; the
      gradient norm's running sum of per-tensor partial squares), and a
      partial sum plus or minus the number 0;
    * a product by a factor replicated on the partial sum's partial mesh
      dims (a scalar, or a DTensor whose other mesh dims are replicated or
      shard what the partial operand shards: it takes those shards, a local
      chunk), when the partial operand has the result's shape.

    None for any other op or operands."""
    if func._overloadpacket is torch.ops.aten.mul:
        return _partial_scaled(func, args, kwargs)
    return _partial_sum(func, args, kwargs)


def _partial_scaled(func, args, kwargs):
    """``_partial_linear``'s products: ``x * c`` and ``c * x`` with ``x`` a
    partial sum and ``c`` replicated on its partial mesh dims."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if len(args) != 2:
        return None
    at = [i for i, a in enumerate(args) if _is_partial_sum(a)]
    if len(at) != 1:
        return None
    x, c = args[at[0]], args[1 - at[0]]
    c_shape = tuple(c.shape) if isinstance(c, torch.Tensor) else ()
    if torch.broadcast_shapes(tuple(x.shape), c_shape) != tuple(x.shape):
        return None
    lead = x.ndim - len(c_shape)
    if isinstance(c, DTensor):
        if c.device_mesh != x.device_mesh:
            return None
        want = []
        for px, pc in zip(x.placements, c.placements):
            d = getattr(px, "dim", -1) - lead
            if type(px) is Shard and d >= 0 and c_shape[d] != 1:
                target = Shard(d)
            elif px.is_partial() or px.is_replicate() or type(px) is Shard:
                target = Replicate()
            else:
                return None
            if pc != target and not pc.is_replicate():
                return None
            want.append(target)
        if tuple(want) != tuple(c.placements):
            c = _reshard(c, want)
        c = c._local_tensor
    elif isinstance(c, torch.Tensor) and c.ndim and any(
            _is_sharded(p) and p.dim - lead >= 0 and c_shape[p.dim - lead] != 1
            for p in x.placements):
        return None  # a whole plain tensor against a shard
    operands = (x._local_tensor, c) if at == [0] else (c, x._local_tensor)
    local = func(*operands, **kwargs)
    return DTensor.from_local(local, x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=contiguous_stride(tuple(x.shape)))


def _reduce_partials(args: tuple) -> tuple:
    """The operands of an elementwise op that ``_partial_linear`` did not
    take (one not linear in a partial sum: ``gelu``, ``sigmoid``, ``pow``,
    ``masked_fill``, a product of two partial sums or by a factor sharded
    where the partial operand is partial, a sum that is not one of partial
    sums): every partial operand is reduced first, by one rule whatever the
    torch version (DTensor's own choice here depends on it: 2.11
    all-reduces, 2.13 reduce-scatters).  On each mesh dim on which an
    operand is a partial sum:

    * reduce-scatter onto the dim that the op's most sharded other operand
      shards on that mesh dim (the one it shares, not a broadcast dim), as
      GSPMD keeps that operand's layout through the op (RMSNorm's scale,
      sharded over the model axis, times the normalized partial sum);
    * else all-reduce to ``Replicate``.  GSPMD resolves a dot's partial sum
      inside the dot, by an all-reduce unless a consumer shards the
      result's dim on that mesh axis; an elementwise consumer whose other
      operands leave that axis free gives it none.  RecurrentGemma's
      long_500k decode (``--multi-pod``), compiled by the JAX package on
      512 virtual devices, issues all-reduces and no reduce-scatter: the
      RG-LRU block's gates and the MLP's activation all-reduce there.

    A shard that its mesh dims do not divide is a ``Replicate`` instead.
    The reductions run through DTensor's redistribution, counted as every
    other (``_redistributions_counted``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dts = [a for a in args if isinstance(a, DTensor)]
    if not any(p.is_partial() for a in dts for p in a.placements):
        return args

    def target(x, i):
        mesh, best = x.device_mesh, None
        for o in dts:
            p = o.placements[i]
            if o is x or o.device_mesh != mesh or type(p) is not Shard:
                continue
            d = p.dim + x.ndim - o.ndim
            if d < 0 or x.shape[d] != o.shape[p.dim]:
                continue
            ways = mesh.size(i) * math.prod(mesh.size(j) for j, q in enumerate(x.placements)
                                            if getattr(q, "dim", None) == d and _is_sharded(q))
            if x.shape[d] % ways == 0 and (best is None or _shards(o) > _shards(best[0])):
                best = (o, d)
        return Replicate() if best is None else Shard(best[1])

    def reduce(x):
        if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
            return x
        return _reshard(x, [target(x, i) if p.is_partial() else p
                            for i, p in enumerate(x.placements)])

    return tuple(reduce(a) for a in args)


def _placed_bmm(args: tuple):
    """``torch.bmm`` of two DTensors, (b, m, k) @ (b, k, n), placed by rule
    on each rank's shards, so DTensor's choice between computing the
    product whole on some mesh dims and sharding it is never consulted (it
    depends on the torch version: 2.11 computes the local attention's
    ``p @ v`` whole on every pod and data rank, 2.13 shards its heads over
    the data axis).  Returns ``(product, result)``, or None.

    * A partial operand is all-reduced first, as GSPMD resolves a dot's
      partial sum inside the dot (XLA's partitioning of RecurrentGemma's
      long_500k decode all-reduces the query after its projection).
    * On a mesh dim on which an operand shards a dim of the product (b, m,
      k or n), the other operand takes the same shards where it holds that
      dim (a local chunk), and the product is sharded there too, or a
      partial sum where the dim is k.
    * The mesh dims on which neither operand is sharded split the
      contraction k, with the mesh dims that already shard it, where they
      divide it, so no rank computes what another computes (the local
      attention's head dim in ``q @ k``, its keys in ``p @ v``); the
      partial sums of that split are all-reduced at once (``result``), so
      the result has the layout that the product computed whole there
      would have had, and only the work is split.

    None where the two operands shard different dims on one mesh dim or a
    placement is not a plain shard: DTensor places those as before."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    a, b = args
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or a.device_mesh != b.device_mesh:
        return None
    mesh = a.device_mesh
    dims = {"a": "bmk", "b": "bkn", "out": "bmn"}
    size = dict(zip("bmk", a.shape)) | {"n": b.shape[2]}
    letter: list[str | None] = []
    for i in range(mesh.ndim):
        held = set()
        for x, ix in ((a, dims["a"]), (b, dims["b"])):
            p = x.placements[i]
            if type(p) is Shard:
                held.add(ix[p.dim])
            elif not (p.is_replicate() or p.is_partial()) or _is_mask_partial(p):
                return None
        if len(held) > 1:
            return None
        letter.append(held.pop() if held else None)
    split = [i for i, l in enumerate(letter) if l is None]
    if split and size["k"] % math.prod(mesh.size(i) for i, l in enumerate(letter)
                                       if l in (None, "k")) == 0:
        letter = ["k" if l is None else l for l in letter]
    else:
        split = []

    def place(x, ix: str):
        want = [Shard(ix.index(l)) if l is not None and l in ix else Replicate() for l in letter]
        if any(p.is_partial() for p in x.placements):
            x = _reshard(x, [Replicate() if p.is_partial() else p for p in x.placements])
        return x if want == list(x.placements) else _reshard(x, want)

    a, b = place(a, dims["a"]), place(b, dims["b"])
    out_placements = [Replicate() if l is None else Partial() if l == "k"
                      else Shard(dims["out"].index(l)) for l in letter]
    shape = (size["b"], size["m"], size["n"])
    local = torch.bmm(a._local_tensor, b._local_tensor)
    product = DTensor.from_local(local, mesh, out_placements, run_check=False,
                                 shape=torch.Size(shape), stride=contiguous_stride(shape))
    if not split:
        return product, product
    return product, _reshard(product, [Replicate() if i in split else p
                                       for i, p in enumerate(out_placements)])


def _partial_sum(func, args, kwargs):
    """``_partial_linear``'s sums and differences."""
    from torch.distributed.tensor import DTensor

    if func._overloadpacket not in _LINEAR_OPS or len(args) != 2:
        return None
    a, b = args
    zero = [x for x, y in ((a, b), (b, a)) if _is_partial_sum(x) and isinstance(y, (int, float))
            and y == 0 and not kwargs]
    if zero:  # x + 0 (Python's sum() starts from 0)
        x = zero[0]
        return DTensor.from_local(func(*(t._local_tensor if t is x else t for t in args)),
                                  x.device_mesh, x.placements, run_check=False, shape=x.shape,
                                  stride=x.stride())
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or a.shape != b.shape \
            or a.device_mesh != b.device_mesh:
        return None
    placements, partial = [], False
    for pa, pb in zip(a.placements, b.placements):
        if _is_mask_partial(pa) or _is_mask_partial(pb):
            return None
        if pa == pb:
            placements.append(pa)
            partial |= pa.is_partial()
        elif pa.is_partial() and pb.is_replicate() or pb.is_partial() and pa.is_replicate():
            placements.append(pa if pa.is_partial() else pb)
            partial = True
        else:
            return None
    if not partial or any(p.is_partial() and p.reduce_op != "sum" for p in placements):
        return None
    local = func(a._local_tensor, b._local_tensor, **kwargs)
    return DTensor.from_local(local, a.device_mesh, placements, run_check=False,
                              shape=a.shape, stride=a.stride())


def _is_view(func) -> bool:
    return func.is_view or func._overloadpacket is torch.ops.aten._unsafe_view


def _split_groups(old: tuple, new: tuple) -> list | None:
    """For a view that only splits dims (and adds size-1 dims), each old
    dim's new dims; None for any other view."""
    groups, j = [], 0
    for size in old:
        dims, prod = [], 1
        while j < len(new) and (prod < size or (not dims and new[j] == 1 and size != 1)):
            prod *= new[j]
            dims.append(j)
            j += 1
        if prod != size or not dims:
            return None
        groups.append(dims)
    while j < len(new) and new[j] == 1 and groups:
        groups[-1].append(j)
        j += 1
    return groups if j == len(new) else None


def _split_view(x, new_shape: tuple):
    """A view that splits a dim sharded over several mesh axes (a flattened
    batch x heads, say), which DTensor refuses: the mesh axes take the new
    dims major to minor, as the nested shards lie, and the local shard is
    viewed to match.  None when the view is not such a split or a shard
    does not fit its factor."""
    from torch.distributed.tensor import DTensor, Shard

    groups = _split_groups(tuple(x.shape), new_shape)
    if groups is None or any(p.is_partial() for p in x.placements):
        return None
    mesh = x.device_mesh
    left = list(new_shape)
    placements = []
    for i, p in enumerate(x.placements):
        d = getattr(p, "dim", None)
        if d is None:
            placements.append(p)
            continue
        n = mesh.size(i)
        at = next((k for k in groups[d] if left[k] % n == 0 and left[k] >= n), None)
        if at is None:
            return None
        left[at] //= n
        placements.append(Shard(at))
    local = x._local_tensor.reshape(left)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(new_shape), stride=contiguous_stride(new_shape))


def _unsharded_past_prefix(x, new_shape):
    """``x`` resharded so that no dim a view splits or merges is sharded:
    every ``Shard`` past the dims the old and new shapes share becomes
    ``Replicate``.  DTensor refuses such a view (GSPMD reshards on its own),
    so the dry run reshards first, as GSPMD would."""
    from torch.distributed.tensor import Replicate

    keep = 0
    for a, b in zip(x.shape, new_shape):
        if a != b:
            break
        keep += 1
    placements = [Replicate() if getattr(p, "dim", -1) >= keep else p for p in x.placements]
    return _reshard(x, placements)


_NEW_TENSOR_OPS = (torch.ops.aten.new_zeros, torch.ops.aten.new_empty, torch.ops.aten.new_ones,
                   torch.ops.aten.new_full)


def _new_like_shards(func, args, kwargs):
    """``x.new_zeros(size)`` and its kin: DTensor makes the new tensor
    replicated, at its whole global size on every rank (a gather's
    backward makes the logits' gradient so).  Here it takes ``x``'s shards
    on the dims whose size it shares, as GSPMD would place it."""
    from torch.distributed.tensor import DTensor, Replicate

    x, size = args[0], tuple(args[1])
    mesh = x.device_mesh
    placements = tuple(
        p if p.is_shard() and p.dim < len(size) and x.shape[p.dim] == size[p.dim] else Replicate()
        for p in x.placements)
    local = func(x._local_tensor, list(local_shape(size, placements, mesh)), *args[2:], **kwargs)
    stride = contiguous_stride(size)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(size), stride=stride)


def _shards(x) -> int:
    return sum(1 for p in x.placements if not p.is_replicate() and not p.is_partial())


def _align_pointwise(args: tuple) -> tuple:
    """An elementwise op's replicated operands take the shards of its most
    sharded operand, on the dims they share (a local chunk: no collective).
    DTensor would rather gather the sharded one; GSPMD propagates the
    shards through elementwise ops, and so does the dry run."""
    from torch.distributed.tensor import DTensor

    dts = [a for a in args if isinstance(a, DTensor)]
    if len(dts) < 2:
        return args
    best = max(dts, key=_shards)
    if not _shards(best):
        return args

    def align(o):
        if not isinstance(o, DTensor) or o is best or o.device_mesh != best.device_mesh:
            return o
        lead = best.ndim - o.ndim
        placements = list(o.placements)
        for i, bp in enumerate(best.placements):
            d = getattr(bp, "dim", None)
            if d is None or not o.placements[i].is_replicate() or d - lead < 0:
                continue
            if o.shape[d - lead] != best.shape[d]:
                continue  # a broadcast dim stays whole
            if bp.is_shard():
                placements[i] = type(bp)(d - lead)
            elif tuple(o.shape) == tuple(best.shape):
                placements[i] = bp  # a strided shard, on an operand of the same shape
        if placements == list(o.placements):
            return o
        return _reshard(o, placements)

    args = tuple(align(a) for a in args)
    # operands of one shape sharded on different dims: all take the layout of
    # the one that shards the leading (batch) dim most, as GSPMD keeps the
    # activations' batch layout through elementwise ops (DTensor's choice
    # here depends on the torch version)
    same = [a for a in args if isinstance(a, DTensor) and a.shape == best.shape
            and a.device_mesh == best.device_mesh and not any(p.is_partial() for p in a.placements)]
    if len({tuple(a.placements) for a in same}) < 2:
        return args
    lead = max(same, key=lambda a: (sum(getattr(p, "dim", None) == 0 for p in a.placements),
                                    _shards(a)))
    return tuple(_reshard(a, lead.placements) if any(a is o for o in same)
                 and tuple(a.placements) != tuple(lead.placements) else a for a in args)


def _is_replicated_scalar(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor) and x.numel() == 1 and all(p.is_replicate() for p in x.placements)


def _expand_over_batch(x, size: tuple):
    """A replicated scalar broadcast to ``size`` (a mean's backward) costs
    nothing to shard: under an activation-sharding context its dim 0 takes
    the batch axes, so the gradient it starts stays batch-sharded (DTensor
    would replicate it, and a gather's backward after it would make the
    logits' gradient whole on every rank).  None when the batch does not
    divide dim 0."""
    from torch.distributed.tensor import DTensor

    from ..parallel.context import current
    from ..parallel.sharding import to_placements

    ctx = current()
    if ctx is None or not ctx.batch_axes or not size or size[0] % ctx.data_size:
        return None
    mesh = x.device_mesh
    placements = to_placements((ctx.batch_axes,), mesh)
    loc = local_shape(size, placements, mesh)
    local = x._local_tensor.reshape(()).expand(loc)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(size),
                              stride=local.stride())


def _is_mask_partial(p) -> bool:
    return type(p).__name__ == "_MaskPartial"


def _reduce_mask_partial(x):
    """A lookup in a sharded table (an embedding or a gather over a sharded
    vocab) leaves a masked partial sum, which DTensor loses track of
    through a later index; the dry run reduces it at once (an all-reduce,
    as GSPMD's lookup has)."""
    from torch.distributed.tensor import Replicate

    placements = [Replicate() if _is_mask_partial(p) else p for p in x.placements]
    return _reshard(x, placements)


def _is_sharded(p) -> bool:
    """A shard, plain or strided (torch 2.13's ``_StridedShard`` answers
    ``is_shard()`` False)."""
    return not (p.is_replicate() or p.is_partial())


def _transition(src, dst) -> str | None:
    """The collective one mesh dim's placement change implies, by the JAX
    parser's kind names; None for a local change (a chunk of a replicated
    or partial tensor, or none)."""
    if src == dst or src.is_replicate():
        return None
    if src.is_partial():
        return "all-reduce" if dst.is_replicate() else None if dst.is_partial() else "reduce-scatter"
    if dst.is_replicate():
        return "all-gather"
    return None if dst.is_partial() else "all-to-all"


@contextlib.contextmanager
def _redistributions_counted(tally: _Tally):
    """Count every redistribution DTensor runs by the placement rule, not
    by the collectives its planner executes (which differ between torch
    versions: 2.13 merges or splits some steps that 2.11 plans otherwise,
    and a CPU mesh has no all-to-all).  Each mesh dim whose placement
    changes is one collective of the kind ``_transition`` names, taken
    innermost mesh dim first; its payload the larger of its local input
    and output bytes (the JAX parser's rule) at that step."""
    from torch.distributed.tensor import _redistribute

    orig = _redistribute.redistribute_local_tensor

    def counted(local_tensor, current_spec, target_spec, *args, **kwargs):
        mesh, nbytes = current_spec.mesh, _local_nbytes(local_tensor)
        steps = zip(current_spec.placements, target_spec.placements)
        for i, (src, dst) in reversed(list(enumerate(steps))):
            kind = _transition(src, dst)
            n = mesh.size(i)
            out = nbytes * n if kind == "all-gather" else \
                nbytes // n if _is_sharded(dst) and not _is_sharded(src) else nbytes
            if kind is not None:
                tally.count(kind, max(nbytes, out))
            nbytes = out
        with _uncounted(tally):
            return orig(local_tensor, current_spec, target_spec, *args, **kwargs)

    mods = [m for name, m in list(sys.modules.items()) if name.startswith("torch.distributed.tensor")
            and getattr(m, "redistribute_local_tensor", None) is orig]
    for m in mods:
        m.redistribute_local_tensor = counted
    try:
        yield
    finally:
        for m in mods:
            m.redistribute_local_tensor = orig


@contextlib.contextmanager
def _uncounted(tally: _Tally):
    saved = (dict(tally.coll_counts), dict(tally.coll_bytes), dict(tally.coll_by_op))
    try:
        yield
    finally:
        for d, old in zip((tally.coll_counts, tally.coll_bytes, tally.coll_by_op), saved):
            d.clear()
            d.update(old)


def _einsum_on_shards(equation: str, a, b):
    """A two-operand einsum of DTensors as GSPMD shards it: on each mesh
    dim the one index either operand is sharded on (plain shards only)
    shards both operands where they hold it (the whole one takes its local
    chunk, no collective), and the output where it holds it, else the
    output is a partial sum over that mesh dim (a contracted index).  Run
    on each rank's shards in a ``local_map`` region, so forward and
    backward compute only what the rank holds.  None where the rule does
    not apply (two indices on one mesh dim, partial or strided operands, a
    size the mesh dim does not divide)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ins, out = equation.replace(" ", "").split("->")
    ia, ib = ins.split(",")
    mesh = a.device_mesh
    if b.device_mesh != mesh:
        return None
    pa, pb, po = [], [], []
    for i in range(mesh.ndim):
        letters = set()
        for x, ix in ((a, ia), (b, ib)):
            p = x.placements[i]
            if type(p) is Shard:
                letters.add(ix[p.dim])
            elif not p.is_replicate():
                return None
        if len(letters) > 1:
            return None
        letter = letters.pop() if letters else ""
        for x, ix, pl in ((a, ia, pa), (b, ib, pb)):
            if letter and letter in ix and x.shape[ix.index(letter)] % mesh.size(i):
                return None
            pl.append(Shard(ix.index(letter)) if letter and letter in ix else Replicate())
        po.append(Shard(out.index(letter)) if letter and letter in out
                  else Partial() if letter else Replicate())
    region = local_map(lambda x, y: torch.einsum(equation, x, y), out_placements=(tuple(po),),
                       in_placements=(tuple(pa), tuple(pb)), device_mesh=mesh,
                       redistribute_inputs=True)
    return region(a, b)


class _ShardedCombine(TorchFunctionMode):
    """The MoE combine einsum (``models.moe.COMBINE``) on DTensors through
    ``_einsum_on_shards``: its expert buffers hold the expert index sharded
    over the model axis, which DTensor would gather to compute the combine
    whole on every rank (forward and backward); GSPMD combines each rank's
    experts and sums the partial outputs.  Every other call runs as is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from ..models.moe import COMBINE
        from ..parallel.sharding import is_dtensor

        if func is torch.einsum and len(args) == 3 and args[0] == COMBINE \
                and is_dtensor(args[1]) and is_dtensor(args[2]) and not kwargs:
            out = _einsum_on_shards(*args)
            if out is not None:
                return out
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def counting():
    """Run under a fresh ``CostMode`` with plain tensors taken as
    replicated (constants, position tables) and the MoE combine sharded as
    GSPMD shards it (``_ShardedCombine``): yields the mode."""
    from torch.distributed.tensor.experimental import implicit_replication

    mode = CostMode()
    with _redistributions_counted(mode.tally), implicit_replication(), _ShardedCombine(), mode:
        yield mode


# ---------------------------------------------------------------------------
# The segments
# ---------------------------------------------------------------------------


def _stage_spec_of(cfg: ArchConfig, rules: ShardingRules, tail: bool):
    pspecs = param_pspecs(param_specs(cfg), rules)
    sub = pspecs["tail"] if tail else pspecs["stages"]

    def spec_of(name: str) -> tuple:
        s = tree_get(sub, name.split("."))
        return s if tail else tuple(s)[1:]  # a stage drops the stacked axis

    return spec_of


def _positions(cfg: ArchConfig, rules: ShardingRules, mesh, batch: int, seq: int, pos0: int = 0):
    ba = rules.batch_axes(batch)
    mrope = cfg.attention is not None and cfg.attention.rope == "mrope"
    shape = (3, batch, seq) if mrope else (batch, seq)
    spec = (None, ba, None) if mrope else (ba, None)
    return fake_dtensor(shape, torch.int64, spec, mesh,
                        fill=lambda loc: (torch.arange(seq) + pos0).expand(loc).contiguous())


def _prefer(rules: ShardingRules, serving: bool) -> str:
    if serving:
        return "tp" if rules.reserve_model else "seq_tp"
    return "tp" if rules.reserve_model else "fsdp"


def keeps_experts(cfg: ArchConfig, rules: ShardingRules, tokens: int) -> bool:
    """Whether the MoE expert tables stay sharded where they are used
    (``distribute_module``'s ``keep_experts``): under the serving rules'
    ``experts_only``, and wherever a block of ``tokens`` runs decode-EP,
    whose products contract the tables' data-sharded dims shard-local, as
    GSPMD computes them (a ZeRO-3 gather would make the backward's
    products whole over the data axes)."""
    from ..models.moe import uses_decode_ep

    return rules.fsdp_data == "experts_only" or (cfg.moe is not None
                                                 and uses_decode_ep(tokens, cfg.moe))


def _grads_to_param_placements(module: nn.Module) -> None:
    for p in module.parameters():
        if p.grad is not None and tuple(p.grad.placements) != tuple(p.placements):
            p.grad = p.grad.redistribute(p.device_mesh, p.placements)


def stage_train_segment(
    cfg: ArchConfig, rules: ShardingRules, mesh, batch: int, seq: int,
    pattern: tuple[str, ...] | None = None,
) -> SegCost:
    """One stage (or the tail, for ``pattern == cfg.tail_pattern``)
    forward and backward at training shape."""
    pattern = tuple(pattern or cfg.pattern)
    tail = bool(cfg.tail_pattern) and pattern == tuple(cfg.tail_pattern)
    ba = rules.batch_axes(batch)
    stage = distribute_module(_sublayers(cfg, pattern, "meta"),
                              _stage_spec_of(cfg, rules, tail), mesh,
                              keep_experts=keeps_experts(cfg, rules, batch * seq))
    x = fake_dtensor((batch, seq, cfg.d_model), cfg.param_dtype, (ba, None, None), mesh)
    x.requires_grad_(True)
    dy = fake_dtensor((batch, seq, cfg.d_model), cfg.param_dtype, (ba, None, None), mesh)
    pos = _positions(cfg, rules, mesh, batch, seq)
    with counting() as mode:
        with activation_sharding(from_rules(rules, batch, prefer=_prefer(rules, False))):
            y = x
            for sub in stage.values():
                y, _ = run_sublayer(sub, y, pos, "none")
        torch.autograd.backward([y], [dy])
        _grads_to_param_placements(stage)
    return mode.tally.seg_cost("stage_train")


def stage_train_local(cfg: ArchConfig, batch: int, seq: int, device, *, remat: str = "none",
                      pattern: tuple[str, ...] | None = None, seed: int | None = 0):
    """One rank's stage segment for real: the stage's sublayers on
    ``device`` (random weights, N(0, 0.02), from ``seed``; None: no
    generator, as under a fake or ``meta`` device, where only shapes
    count), an input and an output gradient of ``(batch, seq, d_model)``.
    Returns ``run()``, one forward and backward as ``stage_train_segment``
    counts it on a rank whose shard is this batch, each sublayer under the
    ``remat`` policy (``run_sublayer``: ``'full'``, ``'dots'`` or ``'none'``)."""
    pattern = tuple(pattern or cfg.pattern)
    device = torch.device(device)
    gen = None if seed is None or device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    stage = _sublayers(cfg, pattern, device)
    with torch.no_grad():
        for p in stage.parameters():
            p.copy_((torch.randn(p.shape, generator=gen, device=device) * 0.02).to(p.dtype))
    shape = (batch, seq, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=device).to(cfg.param_dtype).requires_grad_(True)
    dy = torch.randn(shape, generator=gen, device=device).to(cfg.param_dtype)
    pos = torch.arange(seq, device=device)[None, :].expand(batch, seq)
    if cfg.attention is not None and cfg.attention.rope == "mrope":
        pos = pos[None].expand(3, batch, seq)

    def run():
        y = x
        for sub in stage.values():
            y, _ = run_sublayer(sub, y, pos, remat)
        torch.autograd.backward([y], [dy])

    return run


def stage_fwd_segment(
    cfg: ArchConfig, rules: ShardingRules, mesh, batch: int, seq: int,
    caches: Any = None, cache_sh: Any = None, pos_value: int = 0,
    pattern: tuple[str, ...] | None = None,
) -> SegCost:
    """One stage forward: a prefill without ``caches``, a decode step of
    ``seq`` = 1 token at ``pos_value`` with one stage's cache tree (meta
    tensors) placed by ``cache_sh`` (its specs)."""
    pattern = tuple(pattern or cfg.pattern)
    tail = bool(cfg.tail_pattern) and pattern == tuple(cfg.tail_pattern)
    ba = rules.batch_axes(batch)
    with torch.no_grad():
        stage = distribute_module(_sublayers(cfg, pattern, "meta"),
                                  _stage_spec_of(cfg, rules, tail), mesh,
                                  keep_experts=keeps_experts(cfg, rules, batch * seq))
        x = fake_dtensor((batch, seq, cfg.d_model), cfg.param_dtype, (ba, None, None), mesh)
        pos = _positions(cfg, rules, mesh, batch, seq, pos_value)
        cache = None
        if caches is not None:
            cache = distribute_tree(caches, cache_sh, mesh)
        prefer = "fsdp" if caches is not None else _prefer(rules, True)
        with counting() as mode:
            with activation_sharding(from_rules(rules, batch, prefer=prefer)):
                y = x
                for key, sub in stage.items():
                    c = None if cache is None else cache[key]
                    y, _, _ = sub(y, pos, c, pos_value)
    return mode.tally.seg_cost("stage_fwd")


def _head_params(cfg: ArchConfig, rules: ShardingRules, mesh) -> nn.Module:
    head = nn.Module()
    head.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, device="meta"))
    head.final_norm = make_norm(cfg, "meta")
    if not cfg.tie_embeddings:
        head.head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab, dtype=cfg.param_dtype,
                                             device="meta"))
    pspecs = param_pspecs(param_specs(cfg), rules)
    return distribute_module(head, lambda name: tree_get(pspecs, name.split(".")), mesh)


def _vocab_axis(cfg: ArchConfig, rules: ShardingRules, batch: int) -> str | None:
    ba = rules.batch_axes(batch)
    if ba and rules.model_axis in ba:
        return None
    return rules.model_axis if cfg.vocab % rules.model_size == 0 else None


def head_train_segment(cfg: ArchConfig, rules: ShardingRules, mesh, batch: int, seq: int) -> SegCost:
    """Embed lookup + final norm + head matmul + CE, forward and backward
    (a stand-in activation ``x_mid`` takes the stage stack's place)."""
    ba = rules.batch_axes(batch)
    bspecs = batch_specs(cfg, rules, batch, seq)
    vocab_ax = _vocab_axis(cfg, rules, batch)
    hp = _head_params(cfg, rules, mesh)
    ids = lambda loc: torch.zeros(loc, dtype=torch.int64)
    targets = fake_dtensor((batch, seq), torch.int64, bspecs["targets"], mesh, fill=ids)
    if cfg.input_mode == "embeds":
        inp = fake_dtensor((batch, seq, cfg.d_model), torch.bfloat16, bspecs["embeds"], mesh)
    else:
        inp = fake_dtensor((batch, seq), torch.int64, bspecs["tokens"], mesh, fill=ids)
    x_mid = fake_dtensor((batch, seq, cfg.d_model), cfg.param_dtype, (ba, None, None), mesh)
    with counting() as mode:
        if cfg.input_mode == "embeds":
            x = inp.to(cfg.param_dtype)
        else:
            x = F.embedding(inp, hp.embed).to(cfg.param_dtype)
        x = hp.final_norm(x + x_mid)
        head = hp.embed.T.to(cfg.param_dtype) if cfg.tie_embeddings else hp.head
        logits = with_spec((x @ head).float(), (ba, None, vocab_ax))
        logits = softcap_logits(logits, cfg.logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, targets[..., None])[..., 0]
        loss = torch.mean(lse - ll)
        loss.backward()
        _grads_to_param_placements(hp)
    return mode.tally.seg_cost("head_train")


def head_fwd_segment(cfg: ArchConfig, rules: ShardingRules, mesh, batch: int, seq: int) -> SegCost:
    """Final norm + head, forward only (serving)."""
    ba = rules.batch_axes(batch)
    vocab_ax = _vocab_axis(cfg, rules, batch)
    with torch.no_grad():
        hp = _head_params(cfg, rules, mesh)
        x = fake_dtensor((batch, seq, cfg.d_model), cfg.param_dtype, (ba, None, None), mesh)
        with counting() as mode:
            x = hp.final_norm(x)
            head = hp.embed.T.to(cfg.param_dtype) if cfg.tie_embeddings else hp.head
            logits = with_spec((x @ head).float(), (ba, None, vocab_ax))
            softcap_logits(logits, cfg.logit_softcap)
    return mode.tally.seg_cost("head_fwd")
