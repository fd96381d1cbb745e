"""Hierarchical tree/pipeline reduction fabrics (Wang & Vuduc).

Wang & Vuduc (arXiv 1611.04255, PAPERS.md) price large-fleet reductions
with per-tier *algorithm* choices: a latency-bound tier wants a
binary-tree reduction (startup ``O(log N)`` instead of the ring's
``O(N)``), a bandwidth-bound tier with large messages wants a
*pipelined* tree (segment the message into k chunks so tree hops
overlap, buying back the tree's ``log N`` bandwidth penalty).  This
module adds exactly that degree of freedom to the existing two-tier
composition:

``HierarchicalFabric`` is a ``RingInterconnect`` whose all-reduce
algorithm is selectable per tier (``ici_algo`` / ``dcn_algo`` in
{'ring', 'tree', 'pipeline'}); every other collective and the tier
composition itself (later tiers price a shrunken shard) are inherited
unchanged, so the presets slot into every ``--fabric`` call site.

Algorithm models (paper Table II + the pipelined tree):

  ring      : a = 2(n-1)α              b = (2(n-1)/n)β + ((n-1)/n)γ
  tree      : a = 2α·lg n              b = (2β + γ)·lg n
  pipeline  : affine fit of min_k 2(k + ⌈lg n⌉ - 1)(α + (M/k)(β + γ/2))
              over the standard probe sweep — startup stays O(lg n)
              while the bandwidth term approaches 2β + γ, independent
              of n (the Wang & Vuduc large-message asymptote).

Crossover intuition the simulator exploits: at 10GbE constants, the
tree beats the ring on startup for any fleet over a few nodes (45 µs x
2(N-1) vs x 2 lg N), while its bandwidth term loses at large messages;
the pipelined tree keeps the tree's startup *and* ring-class bandwidth
— which is why it wins the 512-host what-if cells in BENCH_sim.json.
"""

from __future__ import annotations

import dataclasses
import math

from ..core.comm_model import AllReduceModel, binary_tree, fit_affine, ring
from .model import RingInterconnect
from .registry import register_fabric

#: Per-tier all-reduce algorithm choices a HierarchicalFabric accepts.
TIER_ALGOS = ("ring", "tree", "pipeline")

#: Message sizes the pipelined-tree model is affine-fitted over — the
#: same 4 KiB..128 MiB sweep ``planning.costs.DEFAULT_COMM_SWEEP`` probes
#: (duplicated here: the fabric layer cannot import planning).
DEFAULT_PIPELINE_FIT_SWEEP = tuple(4 * 1024 * 8**i for i in range(6))


def pipeline_tree(
    n: int,
    alpha: float,
    beta: float,
    gamma: float,
    fit_sizes: tuple[int, ...] = DEFAULT_PIPELINE_FIT_SWEEP,
) -> AllReduceModel:
    """Pipelined binary-tree all-reduce as an affine (a, b) model.

    The exact cost of reducing ``M`` bytes up a depth-⌈lg n⌉ tree and
    broadcasting back down, with the message segmented into ``k`` chunks
    so hops overlap, is ``T(M, k) = 2 (k + c)(α + (M/k)(β + γ/2))`` with
    ``c = ⌈lg n⌉ - 1``; the optimal segment count is ``k* = sqrt(M c (β
    + γ/2) / α)`` (clamped to >= 1).  ``T(M, k*)`` is concave in ``M``
    (a sqrt term), so it is least-squares fitted over the standard probe
    sweep into the affine currency every policy consumes — the same
    ``fit_affine`` treatment a measured fabric gets."""
    if n <= 1:
        return AllReduceModel(a=0.0, b=0.0, name="noop")
    c = max(0, math.ceil(math.log2(n)) - 1)
    s = beta + gamma / 2.0

    def exact(m: float) -> float:
        k = max(1.0, math.sqrt(m * c * s / alpha)) if alpha > 0 and c > 0 else 1.0
        return 2.0 * (k + c) * (alpha + (m / k) * s)

    model = fit_affine(
        fit_sizes, [exact(m) for m in fit_sizes], name="pipeline_tree"
    )
    # tiny-sweep degeneracy guard: the schedule algebra needs a, b > 0
    a = model.a if model.a > 0 else 2.0 * (1 + c) * alpha
    return AllReduceModel(a=a, b=max(model.b, 2.0 * s), name="pipeline_tree")


@dataclasses.dataclass(frozen=True)
class HierarchicalFabric(RingInterconnect):
    """Two-tier fabric with per-tier all-reduce algorithm selection.

    Inherits every ``RingInterconnect`` constant and its hierarchical
    composition (fast axes first, the ``'pod'`` tier pricing a
    ``1/ici_size`` shard); only the per-tier all-reduce model is swapped
    per ``ici_algo``/``dcn_algo`` ('ring' | 'tree' | 'pipeline').
    Single-phase collectives (reduce-scatter / all-gather / all-to-all)
    ride the inherited ring algebra — tree variants of those are not in
    the Wang & Vuduc treatment and no plan schedules them on these
    presets."""

    ici_algo: str = "tree"
    dcn_algo: str = "tree"
    name: str = "hierarchical"

    def __post_init__(self) -> None:
        for algo in (self.ici_algo, self.dcn_algo):
            if algo not in TIER_ALGOS:
                raise ValueError(
                    f"unknown tier algorithm {algo!r}; known: {TIER_ALGOS}"
                )

    def _tier_allreduce(self, algo: str, n: int, pod: bool) -> AllReduceModel:
        if n <= 1:
            return AllReduceModel(a=0.0, b=0.0, name="noop")
        alpha, beta = self._tier(pod)
        if algo == "ring":
            m = ring(n, alpha, beta, self.gamma)
        elif algo == "tree":
            m = binary_tree(n, alpha, beta, self.gamma)
        else:
            m = pipeline_tree(n, alpha, beta, self.gamma)
        return AllReduceModel(
            a=m.a + self.fixed_overhead, b=m.b, name=f"{'dcn' if pod else 'ici'}_{algo}"
        )

    def ring_axis(self, n: int) -> AllReduceModel:
        """Fast-tier all-reduce phase priced by ``ici_algo``."""
        return self._tier_allreduce(self.ici_algo, n, pod=False)

    def dcn_allreduce(self, n_pods: int) -> AllReduceModel:
        """Cross-pod all-reduce phase priced by ``dcn_algo``."""
        return self._tier_allreduce(self.dcn_algo, n_pods, pod=True)


def _paper_constants() -> dict[str, float]:
    from ..core.comm_model import PAPER_10GBE_ALPHA, PAPER_10GBE_BETA, PAPER_GAMMA

    return dict(
        ici_link_bw=1.0 / PAPER_10GBE_BETA,
        ici_alpha=PAPER_10GBE_ALPHA,
        n_rings=1,
        dcn_bw=1.0 / PAPER_10GBE_BETA,
        dcn_alpha=PAPER_10GBE_ALPHA,
        fixed_overhead=0.0,
        gamma=PAPER_GAMMA,
    )


#: Paper's 10GbE constants with binary-tree reduction on the flat tier:
#: startup O(lg N) instead of the ring's O(N) — the latency-bound regime.
TREE_10GBE = HierarchicalFabric(
    **_paper_constants(), ici_algo="tree", dcn_algo="tree", name="tree_10gbe"
)
#: Paper's 10GbE constants with the pipelined tree: O(lg N) startup AND
#: ring-class bandwidth — Wang & Vuduc's large-fleet workhorse.
PIPELINE_10GBE = HierarchicalFabric(
    **_paper_constants(), ici_algo="pipeline", dcn_algo="pipeline",
    name="pipeline_10gbe",
)
#: TPU v5e ICI rings (a torus is a ring fabric) + a pipelined-tree DCN
#: tier: the two-tier shape a 512-host multi-pod what-if prices.
TPU_V5E_TREE_DCN = HierarchicalFabric(
    ici_algo="ring", dcn_algo="pipeline", name="tpu_v5e_tree_dcn"
)

register_fabric("tree_10gbe", TREE_10GBE)
register_fabric("pipeline_10gbe", PIPELINE_10GBE)
register_fabric("tpu_v5e_tree_dcn", TPU_V5E_TREE_DCN)

__all__ = [
    "HierarchicalFabric",
    "PIPELINE_10GBE",
    "TIER_ALGOS",
    "TREE_10GBE",
    "TPU_V5E_TREE_DCN",
    "pipeline_tree",
]
