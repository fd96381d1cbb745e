"""The Fabric surface: typed collectives + per-op affine cost algebra.

The paper's cost model (Eq. 9, Table II) is an *affine* map ``T(M) = a +
b·M`` derived from the point-to-point primitives (α, β, γ).  Nothing in
that algebra is all-reduce-specific: Table II's derivation applies to any
ring-style collective phase, and Wang & Vuduc (PAPERS.md) run the same
affine treatment for gather/scatter-style collectives.  This module makes
that explicit:

  * ``Collective`` — the typed op vocabulary the planner schedules:
    ``all_reduce`` | ``reduce_scatter`` | ``all_gather`` | ``all_to_all``;
  * ``Fabric``     — the protocol every backend preset implements:
    ``fabric.cost(op, axis_sizes) -> AllReduceModel`` (the affine model
    every policy/Plan already consumes — the *currency* is unchanged,
    only its *source* is now pluggable);
  * ``RingInterconnect`` — the generic two-tier analytic fabric: ring
    collectives on the fast per-axis tier (ICI / NVLink / node-local
    ethernet) plus a ``'pod'`` axis on the slow cross-cluster tier (DCN /
    IB), composed hierarchically exactly like the historical
    ``TpuInterconnect.psum_model`` (which this class absorbs — the
    ``tpu_v5e`` preset in ``presets.py`` IS a ``RingInterconnect`` with
    the TPU constants, and ``core.comm_model`` re-exports it under the
    old names).

Per-phase algebra (ring over one axis of size ``n``):

    reduce_scatter : a = (n-1)·α          b = (n-1)/n · (β + γ)
    all_gather     : a = (n-1)·α          b = (n-1)/n · β
    all_reduce     : reduce_scatter ∘ all_gather  (Table II row 4)
    all_to_all     : a = (n-1)·α          b = (n-1)/n · β

``fixed_overhead`` (dispatch / fusion-barrier cost) is charged per phase
— half for the single-phase ops, whole for the two-phase all-reduce — so
``reduce_scatter + all_gather`` composes to *exactly* the all-reduce
model, and the hierarchical identity

    rs(ici) ⊕ ar(pod, M/ici) ⊕ ag(ici)  ==  psum_model({ici, pod})

holds to the last bit (pinned by ``tests/test_fabric.py``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Protocol, runtime_checkable

from ..core.comm_model import AllReduceModel, ring


class Collective(str, enum.Enum):
    """The typed collective vocabulary the planner can schedule."""

    ALL_REDUCE = "all_reduce"
    REDUCE_SCATTER = "reduce_scatter"
    ALL_GATHER = "all_gather"
    ALL_TO_ALL = "all_to_all"

    def __str__(self) -> str:  # 'all_gather', not 'Collective.ALL_GATHER'
        return self.value


@runtime_checkable
class Fabric(Protocol):
    """A backend interconnect: per-op affine cost models from one place.

    ``cost`` returns the ordinary ``AllReduceModel`` (a, b) pair for one
    collective over the given mesh axes — the same object every scheduler
    policy, ``Plan``, and ``ServePlan`` already consumes, so a fabric
    swap never touches the merge math.
    """

    name: str

    def cost(
        self, op: Collective | str, axis_sizes: dict[str, int]
    ) -> AllReduceModel: ...


@dataclasses.dataclass(frozen=True)
class RingInterconnect:
    """Generic two-tier ring fabric (absorbs the old ``TpuInterconnect``).

    Field names keep the historical TPU vocabulary (``ici_*`` = the fast
    per-axis tier, ``dcn_*`` = the cross-``'pod'`` tier) so the
    ``core.comm_model.TpuInterconnect`` shim is this exact class; presets
    for GPU/NCCL or flat-ethernet clusters just move the constants.

    ici_link_bw   : per-link, per-direction fast-tier bandwidth (B/s)
    ici_alpha     : per-hop fast-tier latency (s)
    n_rings       : parallel rings on the fast tier (multiplies bw)
    dcn_bw        : cross-pod bandwidth per pod (B/s)
    dcn_alpha     : cross-pod startup (s)
    fixed_overhead: per-collective software overhead (dispatch, fusion
                    barrier), charged per ring *phase* (s)
    gamma         : reduction time per byte on one node (s/B)
    """

    ici_link_bw: float = 50e9  # 50 GB/s/link  (TPU v5e ICI)
    ici_alpha: float = 1e-6
    n_rings: int = 1
    dcn_bw: float = 25e9
    dcn_alpha: float = 50e-6
    fixed_overhead: float = 5e-6
    # gamma: on-chip reduce is VPU-bound but effectively free vs the wire;
    # modeled at HBM speed.
    gamma: float = 1.0 / 819e9
    name: str = "tpu_v5e"

    # -- per-axis models ----------------------------------------------------

    def _tier(self, pod: bool) -> tuple[float, float]:
        """(α, β) of one tier."""
        if pod:
            return self.dcn_alpha, 1.0 / self.dcn_bw
        return self.ici_alpha, 1.0 / (self.ici_link_bw * self.n_rings)

    def ring_axis(self, n: int) -> AllReduceModel:
        """Ring all-reduce over one fast-tier mesh axis of size ``n``."""
        if n <= 1:
            return AllReduceModel(a=0.0, b=0.0, name="noop")
        alpha, beta = self._tier(pod=False)
        m = ring(n, alpha, beta, self.gamma)
        return AllReduceModel(a=m.a + self.fixed_overhead, b=m.b, name="ici_ring")

    def dcn_allreduce(self, n_pods: int) -> AllReduceModel:
        """Ring all-reduce across ``n_pods`` pods over the slow tier."""
        if n_pods <= 1:
            return AllReduceModel(a=0.0, b=0.0, name="noop")
        alpha, beta = self._tier(pod=True)
        m = ring(n_pods, alpha, beta, self.gamma)
        return AllReduceModel(a=m.a + self.fixed_overhead, b=m.b, name="dcn_ring")

    def _axis_model(self, op: Collective, n: int, pod: bool) -> AllReduceModel:
        """Affine model of one collective phase over one axis of size ``n``."""
        if n <= 1:
            return AllReduceModel(a=0.0, b=0.0, name="noop")
        if op is Collective.ALL_REDUCE:
            return self.dcn_allreduce(n) if pod else self.ring_axis(n)
        alpha, beta = self._tier(pod)
        frac = (n - 1) / n
        if op is Collective.REDUCE_SCATTER:
            b = frac * (beta + self.gamma)
        else:  # all_gather / all_to_all: pure transmission, no reduction
            b = frac * beta
        # single-phase ops carry half the dispatch overhead so that
        # reduce_scatter + all_gather == all_reduce exactly (module doc)
        return AllReduceModel(
            a=(n - 1) * alpha + self.fixed_overhead / 2, b=b, name=op.value
        )

    # -- the Fabric surface -------------------------------------------------

    def cost(self, op: Collective | str, axis_sizes: dict[str, int]) -> AllReduceModel:
        """Effective (a, b) for ``op`` over the given mesh axes.

        Hierarchical composition (identical to the historical
        ``psum_model``): fast-tier axes are composed as rings with phase
        ``i`` pricing ``1/prod(earlier fast sizes)`` of the message and
        the ``'pod'`` tier pricing ``1/ici_size`` of it.  For the
        scatter direction (all_reduce / reduce_scatter) that is the
        usual "later phases see shrunken shards"; for ``all_gather`` the
        same per-axis fractions describe the mirrored optimal phase
        order — the slow tier gathers first while the data is still
        scattered, the fast tier finishes at full volume — so ``rs + ag
        == all_reduce`` composes tier by tier.  ``all_to_all`` data
        never shrinks (each phase reshuffles the full local volume), so
        every tier prices the whole message.
        """
        op = Collective(op)
        a_total, b_total = 0.0, 0.0
        ici_size = 1
        for axis, n in axis_sizes.items():
            if axis == "pod" or n <= 1:
                continue
            m = self._axis_model(op, n, pod=False)
            a_total += m.a
            b_total += m.b / (1 if op is Collective.ALL_TO_ALL else ici_size)
            ici_size *= n
        n_pods = axis_sizes.get("pod", 1)
        if n_pods > 1:
            m = self._axis_model(op, n_pods, pod=True)
            a_total += m.a
            b_total += m.b / (1 if op is Collective.ALL_TO_ALL else ici_size)
        return AllReduceModel(a=a_total, b=b_total, name=f"{self.name}:{op.value}")

    def psum_model(self, axis_sizes: dict[str, int]) -> AllReduceModel:
        """Historical entry point: effective all-reduce (a, b) for a psum
        over ``axis_sizes`` — kept name-compatible with the old
        ``TpuInterconnect.psum_model`` (``tests/test_fabric.py`` pins the
        two surfaces identical)."""
        m = self.cost(Collective.ALL_REDUCE, axis_sizes)
        return AllReduceModel(a=m.a, b=m.b, name="tpu_psum")
