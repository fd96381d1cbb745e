"""comm_pack parity: the port's pack/unpack against the JAX package's.

The port's plain versions (and its wrappers on CPU tensors) must be
bit-identical to the Pallas kernels in interpret mode (with a small
``chunk``, so the multi-chunk DMA pipeline runs) and to the JAX plain
versions, over part dtype {f32, bf16, mixed} x wire {f32, bf16} x EF
{off, on}, on odd part sizes, with scale 1/3.  The CUDA kernels are held
against the same plain versions on the card in
``test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_env import bits, to_torch
from repro.kernels.comm_pack import (
    pack_arena_pallas,
    pack_arena_ref as jax_pack_ref,
    unpack_arena_pallas,
    unpack_arena_ref as jax_unpack_ref,
)
from repro_torch.kernels.comm_pack import (
    pack_arena,
    pack_arena_ref,
    reset_counts,
    unpack_arena,
    unpack_arena_ref,
)

# odd sizes on purpose: 15, 7, 12, 1, 11, 301, 129 — nothing tile-aligns,
# and the last two span 3 and 2 chunks of CHUNK with ragged tails
SHAPES = ((3, 5), (7,), (2, 2, 3), (1,), (11,), (7, 43), (129,))
CHUNK = 128
SCALE = 1.0 / 3.0
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(part_dt: str, ef: bool, seed: int = 0):
    """Parts (as jax arrays) and residuals, from numpy."""
    rng = np.random.default_rng(seed)
    parts = []
    for i, s in enumerate(SHAPES):
        dt = part_dt if part_dt != "mixed" else ("f32", "bf16")[i % 2]
        parts.append(jnp.asarray(rng.standard_normal(s).astype(np.float32), JAX_DT[dt]))
    res = (
        [jnp.asarray(rng.standard_normal(s).astype(np.float32) * 1e-2) for s in SHAPES]
        if ef else None
    )
    sizes = [int(np.prod(s)) for s in SHAPES]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(int).tolist()
    return parts, res, offsets, sizes, sum(sizes)


@pytest.mark.parametrize("ef", [False, True], ids=["noef", "ef"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("part_dt", ["f32", "bf16", "mixed"])
def test_pack_bit_identical_to_jax(part_dt, wire, ef):
    parts, res, offsets, sizes, total = _inputs(part_dt, ef)
    flat = [p.reshape(-1) for p in parts]
    res_flat = None if res is None else [r.reshape(-1) for r in res]
    a_pal, r_pal = pack_arena_pallas(
        flat, offsets, total, JAX_DT[wire], res_flat, chunk=CHUNK, interpret=True
    )
    a_jref, r_jref = jax_pack_ref(flat, offsets, total, JAX_DT[wire], res_flat)
    np.testing.assert_array_equal(bits(a_pal), bits(a_jref))

    t_parts = [to_torch(p) for p in parts]
    t_res = None if res is None else [to_torch(r) for r in res]
    a_ref, r_ref = pack_arena_ref(t_parts, offsets, total, TORCH_DT[wire], t_res)
    np.testing.assert_array_equal(bits(a_ref), bits(a_pal))

    # the wrapper on CPU tensors: same arena, residuals updated in place
    reset_counts()
    a_op = pack_arena(t_parts, offsets, total, TORCH_DT[wire], t_res)
    np.testing.assert_array_equal(bits(a_op), bits(a_pal))
    assert (pack_arena.ref_calls, pack_arena.launches) == (1, 0)
    if ef:
        for want, got_ref, got_inplace in zip(r_pal, r_ref, t_res):
            np.testing.assert_array_equal(bits(got_ref), bits(want))
            np.testing.assert_array_equal(bits(got_inplace.reshape(-1)), bits(want))
    else:
        assert r_ref is None


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("part_dt", ["f32", "bf16", "mixed"])
def test_unpack_bit_identical_to_jax(part_dt, wire):
    parts, _, offsets, sizes, total = _inputs(part_dt, False, seed=1)
    rng = np.random.default_rng(2)
    arena = jnp.asarray(rng.standard_normal(total).astype(np.float32) * 7.0, JAX_DT[wire])
    slots = list(zip(offsets, sizes))
    dts = [p.dtype for p in parts]
    o_pal = unpack_arena_pallas(
        arena, slots, dts, jnp.asarray([SCALE], jnp.float32), chunk=CHUNK, interpret=True
    )
    o_jref = jax_unpack_ref(arena, slots, dts, SCALE)

    t_arena = to_torch(arena)
    t_dts = [to_torch(p).dtype for p in parts]
    o_ref = unpack_arena_ref(t_arena, slots, t_dts, SCALE)
    reset_counts()
    outs = [torch.empty(p.shape, dtype=dt) for p, dt in zip(parts, t_dts)]
    unpack_arena(t_arena, offsets, outs, SCALE)
    assert (unpack_arena.ref_calls, unpack_arena.launches) == (1, 0)
    for want, jref, got_ref, got_op in zip(o_pal, o_jref, o_ref, outs):
        np.testing.assert_array_equal(bits(want), bits(jref))
        np.testing.assert_array_equal(bits(got_ref), bits(want))
        np.testing.assert_array_equal(bits(got_op.reshape(-1)), bits(want))


def test_round_trip_f32_is_lossless():
    parts, _, offsets, sizes, total = _inputs("f32", False, seed=3)
    t_parts = [to_torch(p) for p in parts]
    arena = pack_arena(t_parts, offsets, total, torch.float32)
    outs = [torch.empty_like(p) for p in t_parts]
    unpack_arena(arena * 4.0, offsets, outs, 0.25)
    for p, o in zip(t_parts, outs):
        np.testing.assert_array_equal(bits(o), bits(p))


def test_error_feedback_reconstructs_accumulator():
    """wire + new residual == grad + old residual, exactly in f32 (the
    bf16 cast error is representable)."""
    parts, res, offsets, sizes, total = _inputs("f32", True, seed=4)
    t_parts = [to_torch(p) for p in parts]
    t_res = [to_torch(r) for r in res]
    acc = [p.float() + r for p, r in zip(t_parts, t_res)]
    arena = pack_arena(t_parts, offsets, total, torch.bfloat16, t_res)
    for a, r, off, n in zip(acc, t_res, offsets, sizes):
        np.testing.assert_array_equal(
            (arena[off : off + n].float() + r.reshape(-1)).numpy(), a.reshape(-1).numpy()
        )


def test_wrapper_rejects_other_devices():
    meta = [torch.empty(4, device="meta")]
    with pytest.raises(ValueError, match="cuda or cpu"):
        pack_arena(meta, [0], 4, torch.float32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        unpack_arena(torch.empty(4, device="meta"), [0], meta)


def test_kernel_table_is_uploaded_once_per_layout():
    """The wrapper keeps one device table per distinct row table, so a
    training step reuses its groups' tables instead of uploading them."""
    from repro_torch.kernels.comm_pack import ops

    rows = [[1, 0, 0, 0, 5, 2], [2, 0, 0, 5, 3, 1]]
    dev = torch.device("cpu")
    first = ops._table(rows, dev)
    assert ops._table([list(r) for r in rows], dev) is first
    assert first.tolist() == [v for r in rows for v in r]
    other = ops._table([[9, 0, 0, 0, 8, 0]], dev)
    assert other is not first and ops._table(rows, dev) is first
