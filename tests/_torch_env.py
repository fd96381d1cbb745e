"""Helpers shared by the PyTorch-port tests (``tests/test_torch_*.py``).

Inputs are made with numpy and handed to both packages; results come
back as numpy and are compared bit for bit (``bits``) or to a stated
tolerance.  Tests that need the card carry the ``cuda`` marker and call
``require_cuda()`` inside the test, so every worker collects the same
tests whether or not it sees a GPU.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

# The suite runs several test processes side by side; at these tiny sizes
# more intra-op threads only contend for the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))


def to_torch(a) -> torch.Tensor:
    """numpy (or jax) array -> CPU tensor with the same bits; bf16 too."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(x) -> np.ndarray:
    """Bit pattern of a tensor or array, for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[x.dtype.itemsize])


def world1() -> None:
    """A gloo process group of one rank on a FileStore, made once per
    process and torn down at exit."""
    if dist.is_initialized():
        return
    tmp = tempfile.mkdtemp(prefix="repro_torch_test_pg_")
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)

    def _down():
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(_down)


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return torch.device("cuda")
