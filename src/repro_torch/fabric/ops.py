"""Typed collective issuing: the one place a ``Collective`` becomes a
``torch.distributed`` call (counterpart of ``repro/fabric/ops.py``).

Every collective goes through ``issue``: the training sync's all-reduces
(one coalesced all-reduce per group under ``fuse='variadic'``), the int8
wire's reduce-scatter and all-gathers (``runtime/compression.py``) and
serving's group collectives (``planning/serve.py``: KV all-gathers and
expert all-to-alls).  There is no compiled program to count
collectives in, so the seam counts its own calls: ``issue.calls`` rises
by one per collective issued, which is how "one all-reduce per schedule
group" is pinned.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .model import Collective


def issue(
    op: Collective | str,
    tensor: torch.Tensor | list[torch.Tensor] | tuple[torch.Tensor, ...],
    group: dist.ProcessGroup | None = None,
    *,
    out: torch.Tensor | None = None,
    async_op: bool = False,
):
    """Issue one collective over ``group`` (the default group when None);
    returns the work handle when ``async_op`` (else None).

    * ``all_reduce`` sums ``tensor`` in place; given a list or tuple of
      tensors (one dtype, one device), it sums them all in one coalesced
      call, the JAX variadic ``psum``;
    * ``reduce_scatter`` sums ``tensor`` over the ranks and writes this
      rank's 1/N slice of the sum into ``out`` (``tensor.numel() / N``
      elements; ``dist.reduce_scatter_tensor``);
    * ``all_gather`` writes every rank's ``tensor``, in rank order, into
      ``out`` (``N x tensor.numel()`` elements;
      ``dist.all_gather_into_tensor``);
    * ``all_to_all`` splits ``tensor`` into N equal chunks along its first
      axis, sends chunk j to rank j and writes the chunks it receives, in
      rank order, into ``out`` (``tensor``'s shape;
      ``dist.all_to_all_single``): the JAX ``all_to_all`` with
      ``split_axis=0`` and ``concat_axis=0``.
    """
    op = Collective(op)
    if isinstance(tensor, (list, tuple)) and op is not Collective.ALL_REDUCE:
        raise ValueError(f"{op.value} takes one tensor, not a list")
    if op is not Collective.ALL_REDUCE and out is None:
        raise ValueError(f"{op.value} needs an output tensor (out=)")
    issue.calls += 1
    if op is Collective.ALL_REDUCE:
        if isinstance(tensor, (list, tuple)):
            return _all_reduce_coalesced(list(tensor), group, async_op)
        return dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group, async_op=async_op)
    if op is Collective.REDUCE_SCATTER:
        return dist.reduce_scatter_tensor(out, tensor, op=dist.ReduceOp.SUM, group=group,
                                          async_op=async_op)
    if op is Collective.ALL_TO_ALL:
        return dist.all_to_all_single(out, tensor, group=group, async_op=async_op)
    return dist.all_gather_into_tensor(out, tensor, group=group, async_op=async_op)


issue.calls = 0


def _all_reduce_coalesced(tensors: list[torch.Tensor], group, async_op: bool):
    """The process group's ``allreduce_coalesced``, called as
    ``dist.all_reduce_coalesced`` calls it but returning the work handle
    itself (``dist.all_reduce_coalesced`` gives a future when asynchronous,
    where the other collectives give their work)."""
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("a coalesced all-reduce takes tensors of one dtype")
    opts = dist.AllreduceCoalescedOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    pg = group if group is not None else dist.distributed_c10d._get_default_group()
    work = pg.allreduce_coalesced(tensors, opts)
    if async_op:
        return work
    work.wait()
    return None
