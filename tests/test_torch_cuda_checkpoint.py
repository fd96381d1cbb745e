"""Checkpoints and the int8 wire of the port on the card.

* ``AsyncCheckpointer.save`` on CUDA tensors copies them to host memory
  (a completed device-to-host copy) before it returns: an in-place update
  of every tensor right after ``save``, while the background write is
  held back, does not reach the file.
* bf16 (special values included), f32 and int64 tensors on the card come
  back bit for bit from a checkpoint, into live CUDA tensors in place.
* ``compressed_psum_rs_ag`` on a one-rank NCCL group: three ``issue()``
  calls, and bit for bit its plain version
  (``compressed_psum_rs_ag_ref``) on the CPU copies of the same inputs.

These tests need an NVIDIA GPU: they carry the ``cuda`` marker and skip
elsewhere.  The file imports no JAX:
``python -m pytest -q -m cuda tests/test_torch_cuda_checkpoint.py``.
"""

import os
import shutil
import tempfile
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_env import bits, require_cuda
from repro_torch.checkpoint import AsyncCheckpointer, restore, save
from repro_torch.checkpoint import checkpoint as ckpt_module
from repro_torch.fabric.ops import issue
from repro_torch.runtime import compressed_psum_rs_ag, compressed_psum_rs_ag_ref


def _tree(device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(1 << 20, generator=gen, device=device).to(torch.bfloat16)
    w[:4] = torch.tensor([float("inf"), float("-inf"), float("nan"), 1e-40], device=device)
    return {
        "params": {"w": w, "b": torch.randn(4097, generator=gen, device=device)},
        "opt_state": {"step": 5, "m": {"w": torch.randn(1 << 20, generator=gen, device=device)},
                      "v": {}},
        "ids": torch.randint(-2**40, 2**40, (333,), generator=gen, device=device),
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else type(tree)(0)


def _tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tensors(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


@pytest.mark.cuda
def test_cuda_bf16_and_friends_round_trip_bitwise(tmp_path):
    dev = require_cuda()
    tree = _tree(dev)
    save(tmp_path, 2, tree, extra={"restarts": 1})
    like = _zeros_like(tree)
    got, extra = restore(tmp_path, 2, like)
    torch.cuda.synchronize()
    assert extra == {"restarts": 1} and got["opt_state"]["step"] == 5
    for name, want in _tensors(tree).items():
        live = _tensors(like)[name]
        assert live.device.type == "cuda" and live.dtype == want.dtype
        assert np.array_equal(bits(live), bits(want)), name


@pytest.mark.cuda
def test_cuda_async_save_does_not_alias_live_tensors(tmp_path, monkeypatch):
    dev = require_cuda()
    release = threading.Event()
    real_save = ckpt_module.save

    def held_save(*args, **kwargs):
        assert release.wait(timeout=120)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(ckpt_module, "save", held_save)
    tree = _tree(dev, seed=1)
    want = {n: t.cpu() for n, t in _tensors(tree).items()}
    writer = AsyncCheckpointer(tmp_path)
    writer.save(7, tree)
    for t in _tensors(tree).values():  # the next step's in-place updates
        t.add_(1)
    torch.cuda.synchronize()
    release.set()
    writer.wait()
    like = _zeros_like(tree)
    restore(tmp_path, 7, like)
    for name, w in want.items():
        assert np.array_equal(bits(_tensors(like)[name]), bits(w)), name
    assert writer.records[0]["bytes"] == sum(t.nbytes for t in want.values())


def _nccl_group():
    """A one-rank NCCL group: the default group when none exists (torn
    down after), else a new NCCL group beside it."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            return None, lambda: None
        return dist.new_group([0], backend="nccl"), lambda: None
    tmp = tempfile.mkdtemp(prefix="repro_torch_cuda_pg_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)

    def down():
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    return None, down


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(33, 7), (2048, 2048)])
def test_cuda_rs_ag_at_nccl_world1_equals_the_plain_version(shape):
    dev = require_cuda()
    group, down = _nccl_group()
    try:
        gen = torch.Generator(device=dev).manual_seed(3)
        g = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
        r = 1e-3 * torch.randn(*shape, generator=gen, device=dev)
        before = issue.calls
        full, res = compressed_psum_rs_ag(g, group, r)
        torch.cuda.synchronize()
        assert issue.calls == before + 3
        (want_full,), (want_res,) = compressed_psum_rs_ag_ref([g.cpu()], [r.cpu()])
        assert full.device.type == "cuda" and full.shape == g.shape
        assert np.array_equal(bits(full), bits(want_full))
        assert np.array_equal(bits(res), bits(want_res))
    finally:
        down()
