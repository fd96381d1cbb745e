"""Analytic backend presets: one registry serves TPU/GPU/CPU clusters.

Constants are per-preset beliefs, not measurements — the ``measured``
path (``MeasuredFabric``) replaces any of them with live timed-collective
fits through the exact same registry surface.

  tpu_v5e     — TPU v5e ICI (2-D torus, 50 GB/s/link, ~1 µs/hop) + DCN
                cross-pod tier: the historical ``TpuInterconnect``
                constants, absorbed (``core.comm_model`` re-exports this
                preset under the old names).
  gpu_nccl    — NVLink-class intra-node tier (~200 GB/s effective ring
                bandwidth, NCCL kernel-launch overhead) + 400 Gb/s-class
                IB/RoCE 'pod' tier: the DGX-pod shape NCCL rings assume.
  dcn_only    — no fast tier at all: every axis rides 100 GbE-class
                datacenter ethernet (CPU clusters, spot fleets).
  paper_10gbe — the paper's own measured environment (§V-A): 8-node K80
                cluster on 10GbE MPI — the Das et al. synchronous-SGD
                setting; ``cost('all_reduce', {'data': N})`` reproduces
                ``comm_model.paper_cluster_model(N)`` exactly.
"""

from __future__ import annotations

from ..core.comm_model import (
    PAPER_10GBE_ALPHA,
    PAPER_10GBE_BETA,
    PAPER_GAMMA,
    AllReduceModel,
)
from .model import Collective, RingInterconnect
from .registry import register_fabric

#: Back-compat alias: the old ``core.comm_model.TpuInterconnect`` class IS
#: the generic two-tier ring fabric (same fields, same defaults).
TpuInterconnect = RingInterconnect

#: Default interconnect for the production mesh in launch/mesh.py — the
#: object ``core.comm_model.TPU_V5E`` has always been.
TPU_V5E = RingInterconnect(name="tpu_v5e")

GPU_NCCL = RingInterconnect(
    ici_link_bw=200e9,  # NVLink ring effective per-direction
    ici_alpha=3e-6,  # NCCL per-hop latency
    n_rings=1,
    dcn_bw=50e9,  # 400 Gb/s IB/RoCE per node
    dcn_alpha=20e-6,
    fixed_overhead=10e-6,  # CUDA kernel launch + NCCL channel setup
    gamma=1.0 / 1500e9,  # HBM-speed local reduction
    name="gpu_nccl",
)

DCN_ONLY = RingInterconnect(
    ici_link_bw=12.5e9,  # 100 GbE
    ici_alpha=25e-6,
    n_rings=1,
    dcn_bw=12.5e9,
    dcn_alpha=100e-6,
    fixed_overhead=20e-6,
    gamma=1.0 / 200e9,  # CPU-socket reduction bandwidth
    name="dcn_only",
)

PAPER_10GBE = RingInterconnect(
    ici_link_bw=1.0 / PAPER_10GBE_BETA,  # ≈ 1.07 GB/s payload bandwidth
    ici_alpha=PAPER_10GBE_ALPHA,
    n_rings=1,
    dcn_bw=1.0 / PAPER_10GBE_BETA,  # one flat 10GbE tier
    dcn_alpha=PAPER_10GBE_ALPHA,
    fixed_overhead=0.0,  # the paper's fit folds software overhead into α
    gamma=PAPER_GAMMA,
    name="paper_10gbe",
)

register_fabric("tpu_v5e", TPU_V5E)
register_fabric("gpu_nccl", GPU_NCCL)
register_fabric("dcn_only", DCN_ONLY)
register_fabric("paper_10gbe", PAPER_10GBE)


def tpu_psum_model(axis_sizes: dict[str, int]) -> AllReduceModel:
    """Historical convenience wrapper: the ``tpu_v5e`` preset's effective
    all-reduce model for ``axis_sizes`` (re-exported by ``core.comm_model``)."""
    return TPU_V5E.psum_model(axis_sizes)


__all__ = [
    "Collective",
    "DCN_ONLY",
    "GPU_NCCL",
    "PAPER_10GBE",
    "TPU_V5E",
    "TpuInterconnect",
    "tpu_psum_model",
]
