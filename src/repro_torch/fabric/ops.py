"""Typed collective issuing: the one place a ``Collective`` becomes a
``torch.distributed`` call (counterpart of ``repro/fabric/ops.py``).

Every gradient collective goes through ``issue``: the training sync's
all-reduces and the int8 wire's reduce-scatter and all-gathers
(``runtime/compression.py``).  There is no compiled program to count
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
    tensor: torch.Tensor,
    group: dist.ProcessGroup | None = None,
    *,
    out: torch.Tensor | None = None,
    async_op: bool = False,
):
    """Issue one collective over ``group`` (the default group when None);
    returns the work handle when ``async_op`` (else None).

    * ``all_reduce`` sums ``tensor`` in place;
    * ``reduce_scatter`` sums ``tensor`` over the ranks and writes this
      rank's 1/N slice of the sum into ``out`` (``tensor.numel() / N``
      elements; ``dist.reduce_scatter_tensor``);
    * ``all_gather`` writes every rank's ``tensor``, in rank order, into
      ``out`` (``N x tensor.numel()`` elements;
      ``dist.all_gather_into_tensor``).

    ``all_to_all`` (MoE expert parallelism) comes with the slice that
    ports the MoE models, and raises until then.
    """
    op = Collective(op)
    if op is Collective.ALL_TO_ALL:
        raise NotImplementedError("all_to_all is ported with the MoE models (mixtral, dbrx)")
    if op is not Collective.ALL_REDUCE and out is None:
        raise ValueError(f"{op.value} needs an output tensor (out=)")
    issue.calls += 1
    if op is Collective.ALL_REDUCE:
        return dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group, async_op=async_op)
    if op is Collective.REDUCE_SCATTER:
        return dist.reduce_scatter_tensor(out, tensor, op=dist.ReduceOp.SUM, group=group,
                                          async_op=async_op)
    return dist.all_gather_into_tensor(out, tensor, group=group, async_op=async_op)


issue.calls = 0
