"""Typed collective issuing: the one place a ``Collective`` becomes a
``torch.distributed`` call (counterpart of ``repro/fabric/ops.py``).

Every gradient reduction of the training sync goes through ``issue``.
There is no compiled program to count collectives in, so the seam counts
its own calls: ``issue.calls`` rises by one per collective issued, which
is how "one all-reduce per schedule group" is pinned.
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
    async_op: bool = False,
):
    """Issue one collective over ``group`` (the default group when None).

    ``all_reduce`` sums ``tensor`` in place and returns the work handle
    when ``async_op`` (else None).  The other collectives are not ported
    yet and raise.
    """
    op = Collective(op)
    if op is not Collective.ALL_REDUCE:
        raise NotImplementedError(f"collective {op.value!r} is not ported yet")
    issue.calls += 1
    return dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group, async_op=async_op)


issue.calls = 0
