"""The AdamW kernel (``repro_torch.kernels.adamw``) against its plain
version, on the card.

Both run on the same CUDA tensors from the same start, three steps with
fresh gradients each (bias corrections of steps 1-3), and must agree bit
for bit on every parameter and both moments: the kernel rounds each
product and sum once, in the plain version's order, and multiplies by the
bias corrections' f32 reciprocals as PyTorch's division by a Python
scalar does on the card.  Covered: (param, grad) dtypes (bf16, bf16),
(f32, f32) and (bf16, f32); leaves of 1, 3, 7, 3,072, 4,097 and 9,437,184
elements in one call; a parameter that starts 2 bytes off 16-byte
alignment and a leaf whose four buffers align together only 3 elements
in; gradients down to 1e-20 (squares below f32's normal range) and exact
zeros; one (49152, 3072) f32 leaf, StarCoder2-3B's tied table; more
leaves than one launch holds; ``adamw_update`` itself on plain tensors and
on DTensors over CUDA shards.  Every call launches the kernel
(``launches`` one a step per launch's worth of leaves) and never the
plain version.

These tests need an NVIDIA GPU: they carry the ``cuda`` marker and skip
elsewhere.  The file imports no JAX:
``python -m pytest -q -m cuda tests/test_torch_cuda_adamw.py``.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_env import bits, require_cuda
from repro_torch.kernels import adamw
from repro_torch.kernels.adamw import ops
from repro_torch.optim import adamw_init, adamw_update

HYPER = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
SIZES = (1, 3, 7, 3072, 4097, 9_437_184)
PAIRS = {"bf16": (torch.bfloat16, torch.bfloat16), "f32": (torch.float32, torch.float32),
         "bf16_f32g": (torch.bfloat16, torch.float32)}


def _bias_corrections(step):
    """(bc1, bc2) as ``adamw_update`` computes them for ``step``."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return tuple(float(1.0 - torch.tensor(b, dtype=torch.float32) ** t)
                 for b in (HYPER["b1"], HYPER["b2"]))


def _grad(rng, n, dtype, dev):
    """Normals at scales from 1e-20 to 10, every 17th element exactly 0."""
    g = rng.standard_normal(n) * 10.0 ** rng.uniform(-20, 1, n)
    g[::17] = 0.0
    return torch.from_numpy(g.astype(np.float32)).to(dtype).to(dev)


def _leaf(rng, n, dtype, dev, offset=0):
    """A fresh parameter of ``n`` elements, ``offset`` elements into its
    storage."""
    base = torch.from_numpy(rng.standard_normal(n + offset).astype(np.float32))
    return base.to(dtype).to(dev)[offset:]


def _state(rng, ps, dev, shift_all=()):
    """Moments from a few earlier steps: m ~ 0.01 N, v ~ 1e-4 U (v >= 0);
    the leaves in ``shift_all`` start one element into their storage."""
    ms, vs = [], []
    for i, p in enumerate(ps):
        o = 1 if i in shift_all else 0
        m = torch.from_numpy((rng.standard_normal(p.numel() + o) * 0.01).astype(np.float32))
        v = torch.from_numpy((rng.random(p.numel() + o) * 1e-4).astype(np.float32))
        ms.append(m.to(dev)[o:].view(p.shape))
        vs.append(v.to(dev)[o:].view(p.shape))
    return ms, vs


def _three_steps(ps, ms, vs, gdtypes, dev, seed, launches_a_step=1, shift_grads=()):
    """Three steps of the kernel and the plain version from the same start;
    asserts equal bits after each step and the launch counts.  The
    gradients of the leaves in ``shift_grads`` start one element into their
    storage."""
    rng = np.random.default_rng(seed)
    ref = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    adamw.reset_counts()
    for step in (1, 2, 3):
        gs = []
        for i, (p, gdt) in enumerate(zip(ps, gdtypes)):
            o = 1 if i in shift_grads else 0
            gs.append(_grad(rng, p.numel() + o, gdt, dev)[o:].view(p.shape))
        bc = _bias_corrections(step)
        adamw.adamw_step(ps, gs, ms, vs, *HYPER.values(), *bc)
        adamw.adamw_step_ref(*ref[:1], gs, *ref[1:], *HYPER.values(), *bc)
        torch.cuda.synchronize()
        assert (adamw.adamw_step.launches, adamw.adamw_step.ref_calls) == (launches_a_step * step, 0)
        for got, want in zip((ps, ms, vs), ref):
            for i, (a, b) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"step {step} leaf {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(PAIRS))
def test_kernel_bit_identical_to_plain(pair):
    dev = require_cuda()
    pdt, gdt = PAIRS[pair]
    rng = np.random.default_rng(0)
    # the last parameter starts 2 (bf16) or 4 (f32) bytes off 16-byte alignment; the leaf
    # before it has all four buffers one element in, so that they align to the kernel's
    # 4-element vectors together 3 elements in
    ps = [_leaf(rng, n, pdt, dev) for n in SIZES] + [_leaf(rng, 4097, pdt, dev, 1),
                                                     _leaf(rng, 4097, pdt, dev, 1)]
    ms, vs = _state(rng, ps, dev, shift_all={len(ps) - 2})
    _three_steps(ps, ms, vs, [gdt] * len(ps), dev, seed=1, shift_grads={len(ps) - 2})


@pytest.mark.cuda
def test_kernel_at_the_tied_table():
    dev = require_cuda()
    rng = np.random.default_rng(2)
    ps = [_leaf(rng, 49152 * 3072, torch.float32, dev).view(49152, 3072),
          _leaf(rng, 3072, torch.bfloat16, dev)]
    ms, vs = _state(rng, ps, dev)
    _three_steps(ps, ms, vs, [torch.float32, torch.bfloat16], dev, seed=3)


@pytest.mark.cuda
def test_more_leaves_than_a_launch_holds():
    dev = require_cuda()
    rng = np.random.default_rng(4)
    sizes = [int(x) for x in rng.integers(1, 20_000, ops.MAX_LEAVES + 90)]
    dts = [PAIRS[list(PAIRS)[i % 3]] for i in range(len(sizes))]
    ps = [_leaf(rng, n, pdt, dev) for n, (pdt, _) in zip(sizes, dts)]
    ms, vs = _state(rng, ps, dev)
    assert len(ops.plan_launches(sizes)) == 2
    _three_steps(ps, ms, vs, [g for _, g in dts], dev, seed=5, launches_a_step=2)


def _update_both(params, grads_by_step, plain):
    """``adamw_update`` over ``params`` for each step's gradients; the plain
    loop on ``plain`` (local tensors) beside it.  Returns both states."""
    state, ref = adamw_init(params), adamw_init(plain)
    for step, grads in enumerate(grads_by_step, 1):
        adamw_update(grads, state, params, HYPER["lr"], HYPER["b1"], HYPER["b2"], HYPER["eps"],
                     HYPER["weight_decay"])
        names = list(plain)
        adamw.adamw_step_ref([plain[n] for n in names], [_local(grads[n]) for n in names],
                             [ref.m[n] for n in names], [ref.v[n] for n in names],
                             *HYPER.values(), *_bias_corrections(step))
    return state, ref


def _nccl_world1():
    """A one-rank NCCL group on a FileStore unless a group exists; returns
    a callable that tears down only what it made, so that no later test
    finds it."""
    if dist.is_initialized():
        return lambda: None
    tmp = tempfile.mkdtemp(prefix="repro_torch_cuda_adamw_pg_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)

    def down():
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    return down


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


@pytest.mark.cuda
@pytest.mark.parametrize("dtensor", [False, True], ids=["tensor", "dtensor"])
def test_adamw_update_takes_the_kernel(dtensor):
    dev = require_cuda()
    rng = np.random.default_rng(6)
    shapes = {"embed": ((512, 64), torch.float32), "w": ((64, 96), torch.bfloat16),
              "scale": ((64,), torch.bfloat16)}
    plain = {n: _leaf(rng, int(np.prod(s)), dt, dev).view(s) for n, (s, dt) in shapes.items()}
    steps = [{n: _grad(rng, p.numel(), p.dtype, dev).view(p.shape) for n, p in plain.items()}
             for _ in range(3)]
    params = {n: p.clone() for n, p in plain.items()}
    down = _nccl_world1() if dtensor else (lambda: None)
    try:
        if dtensor:
            from torch.distributed.device_mesh import DeviceMesh
            from torch.distributed.tensor import DTensor, Replicate

            mesh = DeviceMesh("cuda", [0])

            def wrap(t):
                return DTensor.from_local(t, mesh, [Replicate()], run_check=False)

            params = {n: wrap(p) for n, p in params.items()}
            steps = [{n: wrap(g) for n, g in grads.items()} for grads in steps]
        adamw.reset_counts()
        state, ref = _update_both(params, steps, plain)
        torch.cuda.synchronize()
    finally:
        down()
    assert (adamw.adamw_step.launches, adamw.adamw_step.ref_calls) == (3, 0)
    for n in plain:
        for a, b in ((params[n], plain[n]), (state.m[n], ref.m[n]), (state.v[n], ref.v[n])):
            np.testing.assert_array_equal(bits(_local(a)), bits(b), err_msg=n)
