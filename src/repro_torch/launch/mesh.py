"""Device meshes (counterpart of ``repro/launch/mesh.py``).

A ``torch.distributed`` ``DeviceMesh`` with named dimensions takes the
place of a JAX ``Mesh``: where a JAX function takes a mesh axis name, the
port takes the mesh and the dimension's name, and the process group
behind the dimension is ``mesh.get_group(name)``.  A mesh spans the ranks
of the default process group, which the caller starts first
(``torch.distributed.init_process_group``, or ``ProcessWorld``); defined
as functions, so importing this module touches no process group.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


class ProcessWorld:
    """The launchers' process group: joins the torchrun world when its
    environment is set (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), else makes a world of one on a ``FileStore`` in a
    temporary directory, ``nccl`` for a CUDA device (made the current one
    first, ``LOCAL_RANK``'s when it has no index) and ``gloo`` for the CPU;
    ``close()`` tears down only what it made (a group the caller started
    stays)."""

    def __init__(self, device: torch.device):
        self.made = False
        self.tmp = None
        if dist.is_initialized():
            return
        backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":  # before the group: NCCL binds its communicator to it
            index = device.index
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) if index is None else index)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            self.tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
            store = dist.FileStore(os.path.join(self.tmp, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
        self.made = True

    def close(self) -> None:
        if self.made:
            dist.destroy_process_group()
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks per pod ``("data", "model")``; 2 pods = 512 ranks
    multi-pod ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """An arbitrary mesh over the default group's ranks (tests, reduced
    runs); ``device_type`` is ``"cuda"`` or ``"cpu"``."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
