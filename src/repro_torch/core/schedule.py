"""Gradient-merge schedules: MG-WFBP (paper Algorithm 1) and baselines.

A schedule is a partition of layers ``1..L`` into contiguous groups (see
``core.timeline``).  The paper represents the same object as the set 𝕄 of
*merged-gradient layers*: ``l ∈ 𝕄`` means layer ``l``'s gradients ride with
layer ``l-1`` (operator ``(l) ⊕ (l-1)``, Definition 1).  Both views are
provided, with converters.

Implemented schedulers
----------------------
``wfbp_schedule``        — no merging (one all-reduce per layer)        [10,12]
``synceasgd_schedule``   — single-layer communication (merge all)       [15]
``fixed_bucket_schedule``— size-threshold bucketing (PyTorch-DDP /
                           Horovod tensor-fusion style)                 [19,24]
``mg_wfbp_schedule``     — paper Algorithm 1 / Theorem 1 (merge layer l
                           iff avail(l-1) − τ_c(l) < a), O(L²), run once
``optimal_schedule``     — exact exhaustive minimum over all 2^(L-1)
                           contiguous partitions (small L; used by tests
                           to validate Theorem 1 and as a beyond-paper
                           exact option for coarse layer grouping)
``dp_optimal_schedule``  — beyond-paper: exact optimum in O(L²) time via a
                           Bellman recursion on the channel-free time (see
                           note below)

A note on Theorem 1
-------------------
The paper claims Algorithm 1 is optimal.  Property-testing against
exhaustive enumeration (see ``tests/test_schedule.py``) shows the greedy
is *not* optimal in general — merging layer ``l`` can delay the merged
message enough to hurt *later* (lower-index) groups, which the local
exchange argument in the paper's proof (conditions C.1–C.3 compare only
adjacent terms) does not capture.  Measured on 3000 random instances the
greedy loses ~24% of the time, with worst-case t_iter 20% above optimal;
in the paper's own regime (many small uniform layers, comm-bound) the gap
is ~0.  ``dp_optimal_schedule`` restores exact optimality in O(L²) time,
still a one-time pre-training cost.
"""

from __future__ import annotations

import dataclasses
import itertools

from .comm_model import AllReduceModel
from .cost_model import Hardware, LayerCost, TPU_V5E
from .timeline import TimelineResult, comm_avail_times, evaluate


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A gradient-merge schedule over L layers."""

    groups: tuple[tuple[int, int], ...]  # ascending contiguous (lo, hi), 1-based
    method: str
    result: TimelineResult | None = None  # filled by schedulers that evaluate

    @property
    def num_layers(self) -> int:
        return self.groups[-1][1]

    @property
    def merged_set(self) -> frozenset[int]:
        """The paper's 𝕄: every non-lowest member of each group."""
        m = set()
        for lo, hi in self.groups:
            m.update(range(lo + 1, hi + 1))
        return frozenset(m)

    @property
    def bucket_sizes(self) -> tuple[int, ...]:
        """Group sizes in forward order (used to segment the layer scan)."""
        return tuple(hi - lo + 1 for lo, hi in self.groups)

    def describe(self) -> str:
        gs = ", ".join(f"[{lo}..{hi}]" for lo, hi in self.groups)
        extra = ""
        if self.result is not None:
            extra = f"  t_iter={self.result.t_iter * 1e3:.3f}ms exposed_comm={self.result.t_comm_exposed * 1e3:.3f}ms"
        return f"{self.method}: {len(self.groups)} groups {gs}{extra}"


def groups_from_merged_set(merged: frozenset[int], L: int) -> tuple[tuple[int, int], ...]:
    """Convert the paper's 𝕄 into contiguous groups."""
    groups = []
    lo = 1
    for l in range(2, L + 1):
        if l not in merged:
            groups.append((lo, l - 1))
            lo = l
    groups.append((lo, L))
    return tuple(groups)


def wfbp_schedule(L: int) -> Schedule:
    """WFBP: every layer is its own message (𝕄 = ∅)."""
    return Schedule(groups=tuple((l, l) for l in range(1, L + 1)), method="wfbp")


def synceasgd_schedule(L: int) -> Schedule:
    """SyncEASGD single-layer communication: one message after backward."""
    return Schedule(groups=((1, L),), method="synceasgd")


def fixed_bucket_schedule(costs: list[LayerCost], bucket_bytes: int) -> Schedule:
    """DDP/Horovod-style size-threshold fusion, filled in backward order."""
    L = len(costs)
    groups_rev: list[tuple[int, int]] = []
    hi = L
    acc = 0
    for l in range(L, 0, -1):
        acc += costs[l - 1].grad_bytes
        if acc >= bucket_bytes or l == 1:
            groups_rev.append((l, hi))
            hi = l - 1
            acc = 0
    return Schedule(groups=tuple(reversed(groups_rev)), method=f"fixed_{bucket_bytes}B")


def mg_wfbp_schedule(
    costs: list[LayerCost],
    ar_model: AllReduceModel,
    hw: Hardware = TPU_V5E,
    t_f: float | None = None,
    mode: str = "overlap",
) -> Schedule:
    """Paper Algorithm 1: find all merged-gradient layers 𝕄.

    Runs once before training (O(L²)); merge layer ``l`` into ``l-1`` iff

        τ_b^(l-2) − τ_c^(l) < a                                  (Eq. 27)

    where τ_b^(l-2) = avail(l-1) is when layer l-1's gradient is ready and
    τ_c^(l) is the communication start of layer l under merges so far.
    ``mode`` substitutes the availability vector (``timeline.MODES``):
    under ``serialized`` every gradient becomes communicable only at the
    end of backward, so the greedy merges everything — the algorithm
    degenerates to SyncEASGD, which is exactly right when no overlap is
    possible (startup ``a`` is then paid once).
    """
    L = len(costs)
    if t_f is None:
        t_f = sum(c.t_f(hw) for c in costs)

    # 1-based working arrays (index 0 unused)
    p = [0] + [c.grad_bytes for c in costs]
    tc = [0.0] + [ar_model(c.grad_bytes) for c in costs]
    avail = comm_avail_times(costs, hw, t_f, mode)

    def calc_comm_start() -> list[float]:
        tau_c = [0.0] * (L + 1)
        tau_c[L] = avail[L]
        for l in range(L - 1, 0, -1):
            tau_c[l] = max(tau_c[l + 1] + tc[l + 1], avail[l])
        return tau_c

    merged: set[int] = set()
    tau_c = calc_comm_start()
    for l in range(L, 1, -1):
        # avail of layer l-1's gradient: τ_b^(l-2)  (== avail[l-1])
        ready_prev = avail[l - 1]
        if ready_prev - tau_c[l] < ar_model.a:
            # MERGE(l): layer l rides with layer l-1
            p[l - 1] += p[l]
            p[l] = 0
            tc[l] = 0.0
            tc[l - 1] = ar_model(p[l - 1])
            tau_c = calc_comm_start()
            merged.add(l)

    groups = groups_from_merged_set(frozenset(merged), L)
    res = evaluate(list(groups), costs, ar_model, hw, t_f, mode=mode)
    return Schedule(groups=groups, method="mg_wfbp", result=res)


def optimal_schedule(
    costs: list[LayerCost],
    ar_model: AllReduceModel,
    hw: Hardware = TPU_V5E,
    t_f: float | None = None,
    max_layers: int = 22,
    mode: str = "overlap",
) -> Schedule:
    """Exact minimum-t_iter schedule by exhaustive partition enumeration.

    2^(L-1) candidates — only for modest L (tests, coarse block grouping).
    Ties are broken toward fewer groups (cheaper startup, fewer fusion
    barriers at equal modeled time).
    """
    L = len(costs)
    if L > max_layers:
        raise ValueError(f"exhaustive search over {L} layers is 2^{L - 1} candidates")
    if t_f is None:
        t_f = sum(c.t_f(hw) for c in costs)

    best: tuple[float, int, tuple[tuple[int, int], ...]] | None = None
    best_res = None
    for cuts in itertools.product((False, True), repeat=L - 1):
        groups = []
        lo = 1
        for l, cut in enumerate(cuts, start=2):
            if cut:
                groups.append((lo, l - 1))
                lo = l
        groups.append((lo, L))
        res = evaluate(groups, costs, ar_model, hw, t_f, mode=mode)
        key = (res.t_iter, len(groups), tuple(groups))
        if best is None or key < best:
            best = key
            best_res = res
    assert best is not None
    return Schedule(groups=best[2], method="optimal_exhaustive", result=best_res)


# ---------------------------------------------------------------------------
# Beyond-paper: exact DP
# ---------------------------------------------------------------------------


def dp_optimal_schedule(
    costs: list[LayerCost],
    ar_model: AllReduceModel,
    hw: Hardware = TPU_V5E,
    t_f: float | None = None,
    mode: str = "overlap",
) -> Schedule:
    """Exact minimum-t_iter schedule in O(L^2) time (beyond-paper).

    Key observation: once the layers communicated so far are fixed as a
    partition, the only state the future depends on is the scalar
    channel-free time ``c``; every later group applies the nondecreasing
    map ``c -> max(c, avail) + T_ar(payload)``, so a smaller prefix finish
    can never hurt any continuation.  Hence

        D(k) = min_{0 <= j < k}  max(D(j), avail_bwd(k)) + T_ar(P(j+1..k))

    over *backward positions* k (k = 1 is the paper's layer L) is an exact
    Bellman recursion, with D(L) = optimal t_iter.  This restores the
    optimality that the paper's greedy Algorithm 1 only attains in its
    benign regime (see module docstring) at the same one-time cost.  The
    recursion is mode-agnostic: ``mode`` only swaps the availability
    vector (``timeline.comm_avail_times``), so the DP stays exact for the
    serialized issue order too (where it provably merges everything —
    equal avail makes one group dominate).
    """
    L = len(costs)
    if t_f is None:
        t_f = sum(c.t_f(hw) for c in costs)
    avail_fwd = comm_avail_times(costs, hw, t_f, mode)  # 1-based by fwd layer

    # backward position k <-> forward layer l = L + 1 - k
    avail = [0.0] * (L + 1)
    pre = [0] * (L + 1)  # prefix payload bytes over backward positions
    for k in range(1, L + 1):
        l = L + 1 - k
        avail[k] = avail_fwd[l]
        pre[k] = pre[k - 1] + costs[l - 1].grad_bytes

    D = [0.0] * (L + 1)
    parent = [0] * (L + 1)
    for k in range(1, L + 1):
        best, arg = float("inf"), 0
        for j in range(k):
            v = max(D[j], avail[k]) + ar_model(pre[k] - pre[j])
            if v < best - 1e-18:
                best, arg = v, j
        D[k], parent[k] = best, arg

    # Reconstruct groups (backward positions), convert to forward layers.
    groups = []
    k = L
    while k > 0:
        j = parent[k]
        # backward positions j+1..k == forward layers L+1-k .. L-j
        groups.append((L + 1 - k, L - j))
        k = j
    groups = tuple(sorted(groups))
    res = evaluate(list(groups), costs, ar_model, hw, t_f, mode=mode)
    return Schedule(groups=groups, method="dp_optimal", result=res)


def evaluate_schedule(
    schedule: Schedule,
    costs: list[LayerCost],
    ar_model: AllReduceModel,
    hw: Hardware = TPU_V5E,
    t_f: float | None = None,
    mode: str = "overlap",
) -> Schedule:
    """Attach a TimelineResult to a schedule produced without evaluation."""
    res = evaluate(list(schedule.groups), costs, ar_model, hw, t_f, mode=mode)
    return dataclasses.replace(schedule, result=res)
