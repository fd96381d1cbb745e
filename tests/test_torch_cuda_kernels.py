"""The comm_pack CUDA kernels against their plain PyTorch versions, on the
card: bit-identical arena, residuals and unpacked parts over part dtype
{f32, bf16, mixed} x wire {f32, bf16} x EF {off, on}, at odd sizes and
offsets, sources that are not 16-byte aligned, and scale 1/3.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU interpret mode):
they carry the ``cuda`` marker and skip elsewhere.  The file imports no
JAX, so it runs on a machine that has only the port's dependencies:
``python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from _torch_env import bits, require_cuda
from repro_torch.kernels.comm_pack import (
    pack_arena,
    pack_arena_ref,
    reset_counts,
    unpack_arena,
    unpack_arena_ref,
)

SIZES = (15, 7, 12, 1, 11, 301, 129, 8, 65_539, 3)
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _parts(part_dt, ef, device, seed=0):
    rng = np.random.default_rng(seed)
    parts, res = [], []
    for i, n in enumerate(SIZES):
        dt = part_dt if part_dt != "mixed" else ("f32", "bf16")[i % 2]
        base = torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32)).to(TORCH_DT[dt])
        # every third part is a view at storage offset 1: not 16-byte aligned
        parts.append((base[1:] if i % 3 == 2 else base[:n].clone()).to(device))
        res.append(torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-2).to(device))
    offsets = np.concatenate([[0], np.cumsum(SIZES)[:-1]]).astype(int).tolist()
    return parts, (res if ef else None), offsets, sum(SIZES)


@pytest.mark.cuda
@pytest.mark.parametrize("ef", [False, True], ids=["noef", "ef"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("part_dt", ["f32", "bf16", "mixed"])
def test_cuda_kernels_bit_identical_to_plain(part_dt, wire, ef):
    dev = require_cuda()
    parts, res, offsets, total = _parts(part_dt, ef, dev)
    want, want_res = pack_arena_ref(parts, offsets, total, TORCH_DT[wire], res)
    got_res = None if res is None else [r.clone() for r in res]
    reset_counts()
    got = pack_arena(parts, offsets, total, TORCH_DT[wire], got_res)
    torch.cuda.synchronize()
    assert (pack_arena.launches, pack_arena.ref_calls) == (1, 0)
    np.testing.assert_array_equal(bits(got), bits(want))
    if ef:
        for w, g in zip(want_res, got_res):
            np.testing.assert_array_equal(bits(g), bits(w))
    outs = [torch.empty(p.shape, dtype=p.dtype, device=dev) for p in parts]
    unpack_arena(got, offsets, outs, 1.0 / 3.0)
    want_out = unpack_arena_ref(got, list(zip(offsets, SIZES)), [p.dtype for p in parts], 1.0 / 3.0)
    torch.cuda.synchronize()
    assert (unpack_arena.launches, unpack_arena.ref_calls) == (1, 0)
    for w, g in zip(want_out, outs):
        np.testing.assert_array_equal(bits(g), bits(w))


@pytest.mark.cuda
def test_cuda_wrapper_rejects_gapped_offsets():
    dev = require_cuda()
    parts = [torch.ones(4, device=dev), torch.ones(4, device=dev)]
    with pytest.raises(ValueError, match="exact packing"):
        pack_arena(parts, [0, 5], 9, torch.float32)
