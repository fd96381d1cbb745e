"""The Fabric API: typed collectives + backend-preset registry.

    from repro_torch.fabric import get_fabric, Collective

    fabric = get_fabric("gpu_nccl")
    ar = fabric.cost(Collective.ALL_REDUCE, {"data": 32})   # AllReduceModel

``cost`` returns the affine ``AllReduceModel`` every scheduler policy and
``Plan`` consumes; ``fabric.ops.issue`` is the executable counterpart over
``torch.distributed``; ``MeasuredFabric`` serves timed all-reduce fits
(``planning.MeasuredComm``) through the same ``cost`` surface.
"""

from .hierarchical import (
    PIPELINE_10GBE,
    TPU_V5E_TREE_DCN,
    TREE_10GBE,
    HierarchicalFabric,
)
from .measured import MeasuredFabric
from .model import Collective, Fabric, RingInterconnect
from .ops import issue
from .presets import DCN_ONLY, GPU_NCCL, PAPER_10GBE, TPU_V5E, TpuInterconnect
from .registry import available_fabrics, get_fabric, register_fabric

__all__ = [
    "Collective",
    "DCN_ONLY",
    "Fabric",
    "GPU_NCCL",
    "HierarchicalFabric",
    "MeasuredFabric",
    "PAPER_10GBE",
    "PIPELINE_10GBE",
    "RingInterconnect",
    "TPU_V5E",
    "TPU_V5E_TREE_DCN",
    "TREE_10GBE",
    "TpuInterconnect",
    "available_fabrics",
    "get_fabric",
    "issue",
    "register_fabric",
]
