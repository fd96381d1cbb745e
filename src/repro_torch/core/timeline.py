"""Discrete WFBP timeline evaluation (paper Eqs. 6–8 and 19–21).

Layer convention follows the paper: layers are numbered ``1..L`` in forward
order; backward propagation runs ``L -> 1``; the gradient of layer ``l``
becomes *available* when its backward step finishes; gradient communication
of distinct messages is serialized on one channel (all-reduce is a
collective — only one can make full-bandwidth progress at a time) but
overlaps freely with backward compute.

A *schedule* partitions layers into contiguous groups.  A group ``[lo..hi]``
(1-based, inclusive) is communicated as one merged message whose payload is
the sum of member gradient sizes, becoming available when the gradient of
``lo`` (computed last during backward) is ready.  Groups are communicated in
backward order: the group containing layer ``L`` first, the group containing
layer ``1`` last.  WFBP is the all-singleton partition; SyncEASGD is the
single-group partition; MG-WFBP picks the optimum (paper Theorem 1).

Two *issue-order modes* price the same partition against two executions:

  ``overlap``     — the WFBP/MG-WFBP DAG execution (Shi et al.'s DAG model
                    of S-SGD, arXiv 1805.03812): group g's merged message
                    becomes available the moment its lowest layer's
                    gradient lands, so its wire time hides behind the
                    backward compute of groups g+1.. (the historical — and
                    default — semantics of this module).
  ``serialized``  — the post-backward execution: no message may start
                    before the whole backward pass finishes (the behavior
                    of a train step that synchronizes after
                    ``value_and_grad`` returns).  Same channel law, same
                    payloads — only the availability times move.

For any partition, overlapped ``t_iter`` <= serialized ``t_iter`` (comm
can only start earlier); the property suite pins this.
"""

from __future__ import annotations

import dataclasses

from .comm_model import AllReduceModel
from .cost_model import Hardware, LayerCost, TPU_V5E


@dataclasses.dataclass(frozen=True)
class GroupTrace:
    """Timeline of one merged communication group."""

    layers: tuple[int, int]  # (lo, hi), 1-based inclusive
    nbytes: int
    avail: float  # when the merged gradient is fully available
    start: float  # τ_c — when the all-reduce starts
    finish: float  # when the all-reduce completes


@dataclasses.dataclass(frozen=True)
class TimelineResult:
    """Evaluated iteration timeline for one schedule."""

    t_iter: float
    t_f: float
    t_b: float
    t_comm_total: float  # Σ T_ar over groups (pure wire time)
    t_comm_exposed: float  # t_c^no: non-overlapped communication (paper Fig. 8)
    groups: tuple[GroupTrace, ...]

    @property
    def comm_ratio(self) -> float:
        """r = t_c^no / (t_f + t_b) (paper §II-C)."""
        return self.t_comm_exposed / (self.t_f + self.t_b)

    def speedup(self, n: int) -> float:
        """S(N) = N (t_f + t_b) / t_iter (paper Eq. 4)."""
        return n * (self.t_f + self.t_b) / self.t_iter


def backward_start_times(costs: list[LayerCost], hw: Hardware, t_f: float) -> list[float]:
    """τ_b per layer, 1-based list of length L+1 (index 0 unused).

    τ_b[L] = t_f;  τ_b[l] = τ_b[l+1] + t_b[l+1]                    (Eq. 6/19)
    """
    L = len(costs)
    tau_b = [0.0] * (L + 1)
    tau_b[L] = t_f
    for l in range(L - 1, 0, -1):
        tau_b[l] = tau_b[l + 1] + costs[l].t_b(hw)  # costs is 0-based
    return tau_b


def gradient_avail_times(costs: list[LayerCost], hw: Hardware, t_f: float) -> list[float]:
    """avail[l] = τ_b[l] + t_b[l] — when layer l's gradient is ready."""
    tau_b = backward_start_times(costs, hw, t_f)
    L = len(costs)
    return [0.0] + [tau_b[l] + costs[l - 1].t_b(hw) for l in range(1, L + 1)]


#: Issue-order modes the timeline can price (see module docstring).
MODES = ("overlap", "serialized")


def comm_avail_times(
    costs: list[LayerCost], hw: Hardware, t_f: float, mode: str = "overlap"
) -> list[float]:
    """Per-layer communication availability under an issue-order mode.

    ``overlap``: layer l's message may go the moment its gradient lands
    (``gradient_avail_times``).  ``serialized``: every message waits for
    the end of backward (``t_f + Σ t_b``) — the post-backward step.
    1-based list of length L+1 (index 0 unused).
    """
    if mode not in MODES:
        raise ValueError(f"unknown issue-order mode {mode!r}; known: {MODES}")
    if mode == "overlap":
        return gradient_avail_times(costs, hw, t_f)
    end = t_f + sum(c.t_b(hw) for c in costs)
    return [0.0] + [end] * len(costs)


def evaluate(
    groups: list[tuple[int, int]],
    costs: list[LayerCost],
    ar_model: AllReduceModel,
    hw: Hardware = TPU_V5E,
    t_f: float | None = None,
    mode: str = "overlap",
) -> TimelineResult:
    """Evaluate a contiguous-partition schedule against the WFBP timeline.

    ``groups`` are (lo, hi) 1-based inclusive ranges covering 1..L exactly,
    in ascending order.  Returns the full per-group trace.  ``mode``
    selects the issue order the schedule executes under: ``overlap``
    (default — comm of group g hides behind backward of groups g+1..) or
    ``serialized`` (all comm waits for the end of backward).
    """
    L = len(costs)
    _check_partition(groups, L)
    if t_f is None:
        t_f = sum(c.t_f(hw) for c in costs)
    t_b_total = sum(c.t_b(hw) for c in costs)
    avail = comm_avail_times(costs, hw, t_f, mode)

    traces: list[GroupTrace] = []
    channel_free = 0.0
    for lo, hi in reversed(groups):  # backward (descending) order
        nbytes = sum(costs[i - 1].grad_bytes for i in range(lo, hi + 1))
        t_avail = avail[lo]  # lowest layer's gradient lands last
        start = max(channel_free, t_avail)
        finish = start + ar_model(nbytes)
        traces.append(GroupTrace((lo, hi), nbytes, t_avail, start, finish))
        channel_free = finish

    t_iter = max(traces[-1].finish, t_f + t_b_total)
    t_comm_total = sum(tr.finish - tr.start for tr in traces)
    return TimelineResult(
        t_iter=t_iter,
        t_f=t_f,
        t_b=t_b_total,
        t_comm_total=t_comm_total,
        t_comm_exposed=t_iter - (t_f + t_b_total),
        groups=tuple(traces),
    )


def _check_partition(groups: list[tuple[int, int]], L: int) -> None:
    if not groups:
        raise ValueError("empty schedule")
    expect = 1
    for lo, hi in groups:
        if lo != expect or hi < lo:
            raise ValueError(f"groups {groups} are not a contiguous partition of 1..{L}")
        expect = hi + 1
    if expect != L + 1:
        raise ValueError(f"groups {groups} do not cover 1..{L}")
