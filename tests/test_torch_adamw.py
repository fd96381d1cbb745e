"""The AdamW step's wrapper on the CPU (``repro_torch.kernels.adamw``).

The wrapper dispatches on where the parameters lie: CPU and ``meta``
tensors take the plain loop and launch nothing.  The kernel itself runs
only on the card (``tests/test_torch_cuda_adamw.py``); here its host side
is held: ``plan_launches`` cuts ragged leaf lists into launches whose
chunks, found as the kernel finds them (the last row whose first chunk is
at most the block's index), cover every element exactly once; and the
table a step hands the library, read back from memory by a stand-in that
walks each chunk's scalar head, 4-wide body and scalar tail by the
kernel's own formulas, names every leaf's four buffers, its size and
dtypes, reaches every element exactly once, and carries the scalars as
given; the table is kept with its owner and built anew when a leaf's
buffers or a gradient's dtype change.  Last, ``adamw_update`` still agrees with the JAX package's over 3
steps on a mix of bf16 and f32 leaves and gradients.

Tolerances against JAX: the same f32 expressions, which XLA may fuse into
FMAs and whose scalar divisions it may take otherwise (the port's plain
loop divides, the kernel multiplies by the f32 reciprocal as PyTorch does
on the card): f32 within 1e-6 relative; a bf16 parameter may land one bf16
step away where that last f32 bit decides its rounding.
"""

import bisect
import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.optimizers import adamw_init as jax_adamw_init
from repro.optim.optimizers import adamw_update as jax_adamw_update
from repro_torch.kernels import adamw
from repro_torch.kernels import launch_counts
from repro_torch.kernels.adamw import ops
from repro_torch.optim import adamw_init, adamw_update

CHUNK = ops.CHUNK
RAGGED = [
    [1, 3, 7, 3072, 4097],
    [0, 5, 0, CHUNK, CHUNK + 1, 2 * CHUNK - 1, 0],
    [CHUNK * 3 + 17] + [1] * 40 + [CHUNK - 1, 0, 2],
]


def _leaves(sizes, pairs, seed=0, misalign=(), shift_all=()):
    """(params, grads, ms, vs): leaf i with (param, grad) dtypes
    ``pairs[i % len(pairs)]``.  The parameters of the leaves in
    ``misalign`` are views at storage offset 1 (2 or 4 bytes off 16-byte
    alignment, where the other three buffers are aligned); in ``shift_all``
    all four buffers are, so that they align together a few elements in."""
    rng = np.random.default_rng(seed)
    ps, gs, ms, vs = [], [], [], []

    def make(x, dtype, shifted):
        t = torch.from_numpy(np.concatenate([[0.0], x]).astype(np.float32)).to(dtype)
        return t[1:] if shifted else t[1:].clone()

    for i, n in enumerate(sizes):
        pdt, gdt = pairs[i % len(pairs)]
        ps.append(make(rng.standard_normal(n), pdt, i in misalign or i in shift_all))
        gs.append(make(rng.standard_normal(n), gdt, i in shift_all))
        ms.append(make(rng.standard_normal(n) * 0.1, torch.float32, i in shift_all))
        vs.append(make(rng.random(n) * 0.1, torch.float32, i in shift_all))
    return ps, gs, ms, vs


def _block_range(launch, numels, b):
    """(leaf, first element, end) of block ``b``, found as the kernel
    finds it."""
    k = bisect.bisect_right(launch.chunk0, b) - 1
    c0 = (b - launch.chunk0[k]) * CHUNK
    return launch.first + k, c0, min(c0 + CHUNK, numels[launch.first + k])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_take_the_plain_loop(device):
    leaves = _leaves([5, 3072], [(torch.bfloat16, torch.float32)])
    ps, gs, ms, vs = ([t.to(device) for t in ts] for ts in leaves)
    want = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    start = ps[1].clone()
    args = (1e-3, 0.9, 0.95, 1e-8, 0.1, 0.1, 0.0975)
    adamw.reset_counts()
    adamw.adamw_step(ps, gs, ms, vs, *args)
    assert (adamw.adamw_step.ref_calls, adamw.adamw_step.launches) == (1, 0)
    assert launch_counts()["adamw_step"] == 0
    if device == "cpu":
        adamw.adamw_step_ref(want[0], gs, want[1], want[2], *args)
        for got, ref in zip((ps, ms, vs), want):
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert not torch.equal(ps[1], start)


@pytest.mark.parametrize("max_leaves", [ops.MAX_LEAVES, 7, 3, 1])
@pytest.mark.parametrize("sizes", RAGGED + [[7] * 1100, [0] * 600 + [5, 0]],
                         ids=["small", "zeros", "long", "many", "empty_launch"])
def test_launches_cover_every_element_once(sizes, max_leaves):
    launches = ops.plan_launches(sizes, max_leaves, CHUNK)
    seen = [np.zeros(n, dtype=np.int64) for n in sizes]
    for launch in launches:
        assert 0 < launch.stop - launch.first <= max_leaves and launch.n_chunks > 0
        assert list(launch.chunk0) == sorted(launch.chunk0)
        for b in range(launch.n_chunks):
            leaf, j0, j1 = _block_range(launch, sizes, b)
            assert j0 < j1
            seen[leaf][j0:j1] += 1
    assert all((s == 1).all() for s in seen)
    leaves = [i for la in launches for i in range(la.first, la.stop)]
    assert leaves == sorted(set(leaves))  # launches take the leaves in order, each once


class _StandIn:
    """Reads each launch's table from memory and walks every block's
    elements by the kernel's formulas, counting each visit in a ``seen``
    array per leaf (by the first-moment buffer's address)."""

    def __init__(self, seen_by_m):
        self.seen, self.calls = seen_by_m, []

    def adamw_launch(self, rows_addr, n_leaves, n_chunks, *rest):
        *scalars, stream = rest
        rows = np.ctypeslib.as_array((ctypes.c_int64 * (7 * n_leaves)).from_address(rows_addr))
        rows = rows.reshape(n_leaves, 7).copy()
        self.calls.append((rows, n_chunks, scalars, stream))
        for b in range(n_chunks):
            k = int(np.searchsorted(rows[:, 5], b, side="right")) - 1
            p, g, m, v, n, chunk0, flags = (int(x) for x in rows[k])
            ps, gs = (2 if flags & 1 else 4), (2 if flags & 2 else 4)
            head = next((j for j in range(4) if (p + j * ps) % (4 * ps) == 0
                         and (g + j * gs) % (4 * gs) == 0 and (m + 4 * j) % 16 == 0
                         and (v + 4 * j) % 16 == 0), -1)
            c0 = (b - chunk0) * CHUNK
            c1 = min(c0 + CHUNK, n)
            v0 = c1 if head < 0 or c0 + head > c1 else c0 + head
            v1 = v0 + (c1 - v0) // 4 * 4
            seen = self.seen[m]
            seen[c0:v0] += 1
            for j in range(v0, v1, 4):
                assert (p + j * ps) % (4 * ps) == 0 and (g + j * gs) % (4 * gs) == 0
                assert (m + 4 * j) % 16 == 0 and (v + 4 * j) % 16 == 0
                seen[j:j + 4] += 1
            seen[v1:c1] += 1
        return 0


@pytest.mark.parametrize("sizes", RAGGED + [[3] * 600], ids=["small", "zeros", "long", "many"])
def test_the_step_table_names_every_leaf_and_element_once(sizes):
    pairs = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.bfloat16, torch.float32)]
    ps, gs, ms, vs = _leaves(sizes, pairs, misalign={1, 4}, shift_all={2, 3})
    seen = {m.data_ptr(): np.zeros(m.numel(), dtype=np.int64) for m in ms}
    lib = _StandIn(seen)
    adamw.reset_counts()
    scalars = (3e-4, 0.9, 0.95, 1e-8, 0.1, 0.1, 0.0975)
    owner, layouts = _Owner(), []
    for step in range(2):  # the second step reuses the table with new gradients
        seen_before = {k: s.copy() for k, s in seen.items()}
        ops._launch(lib, 1234, owner, ps, gs, ms, vs, *scalars)
        for m in ms:
            assert (seen[m.data_ptr()] - seen_before[m.data_ptr()] == 1).all()
        rows = np.concatenate([r for r, *_ in lib.calls[-len(ops.plan_launches(sizes)):]])
        kept = [i for i, n in enumerate(sizes) if n]
        by_leaf = {int(r[2]): r for r in rows}
        for i in kept:
            r = by_leaf[ms[i].data_ptr()]
            assert (r[0], r[1], r[3], r[4]) == (ps[i].data_ptr(), gs[i].data_ptr(),
                                                vs[i].data_ptr(), sizes[i])
            assert r[6] == (ps[i].dtype == torch.bfloat16) + 2 * (gs[i].dtype == torch.bfloat16)
        gs = [g.clone() for g in gs]
        layouts.append(ops._LAYOUTS[id(owner)])
    assert layouts[0] is layouts[1]
    n_launch = len(ops.plan_launches(sizes))
    assert n_launch == (2 if len(sizes) > ops.MAX_LEAVES else 1)
    assert adamw.adamw_step.launches == 2 * n_launch and adamw.adamw_step.ref_calls == 0
    assert all(tuple(s) == scalars and stream == 1234 for _, _, s, stream in lib.calls)


def test_the_step_refuses_gradients_that_do_not_fit():
    ps, gs, ms, vs = _leaves([5, 9], [(torch.bfloat16, torch.bfloat16)])
    lib = _StandIn({})
    with pytest.raises(ValueError, match="gradients"):
        ops._launch(lib, 0, None, ps, [gs[0], gs[1][:8]], ms, vs, *([0.1] * 7))
    with pytest.raises(ValueError, match="gradients"):
        ops._launch(lib, 0, None, ps, [gs[0], torch.zeros(18)[::2]], ms, vs, *([0.1] * 7))
    with pytest.raises(ValueError, match="moments"):
        ops._launch(lib, 0, None, ps, gs, [ms[0], ms[1].double()], vs, *([0.1] * 7))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        ops._launch(lib, 0, None, [ps[0].half(), ps[1]], gs, ms, vs, *([0.1] * 7))
    assert not lib.calls


class _Owner:
    """Something to keep a leaf table with, as ``adamw_update`` keeps it with
    its optimizer state."""


def _rows(lib):
    """The last launch's table rows, by first-moment address."""
    return {int(r[2]): r for r in lib.calls[-1][0]}


CHANGES = ["none", "param_storage", "param_object", "moment_object", "grad_dtype", "no_owner",
           "owner_dropped"]


@pytest.mark.parametrize("change", CHANGES)
def test_the_table_is_kept_with_its_owner_until_the_leaves_change(change):
    """A second step reuses the owner's table unless a parameter moved or
    was replaced, a moment was replaced or a gradient changed dtype; then
    the table is built anew and names the new buffers.  Without an owner
    every call builds one; a dropped owner's table goes with it."""
    pairs = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)]
    ps, gs, ms, vs = _leaves([5, 3072, 9], pairs)
    seen = {m.data_ptr(): np.zeros(m.numel(), dtype=np.int64) for m in ms}
    lib, owner = _StandIn(seen), (None if change == "no_owner" else _Owner())
    scalars = (3e-4, 0.9, 0.95, 1e-8, 0.1, 0.1, 0.0975)
    ops._launch(lib, 0, owner, ps, gs, ms, vs, *scalars)
    first = ops._LAYOUTS.get(id(owner))
    assert (first is None) == (owner is None)
    gs = [g.clone() for g in gs]
    if change == "param_storage":  # the same parameter object, its storage elsewhere
        ps[1].data = ps[1].data.clone()
    elif change == "param_object":
        ps[1] = ps[1].clone()
    elif change == "moment_object":
        ms[1] = ms[1].clone()
        seen[ms[1].data_ptr()] = np.zeros(ms[1].numel(), dtype=np.int64)
    elif change == "grad_dtype":
        gs[0] = gs[0].float()
    elif change == "owner_dropped":
        key = id(owner)
        del owner
        gc.collect()
        assert key not in ops._LAYOUTS
        return
    ops._launch(lib, 0, owner, ps, gs, ms, vs, *scalars)
    assert (ops._LAYOUTS.get(id(owner)) is first) == (change in ("none", "no_owner"))
    rows = _rows(lib)
    for p, g, m in zip(ps, gs, ms):
        r = rows[m.data_ptr()]
        assert (r[0], r[1]) == (p.data_ptr(), g.data_ptr())
        assert r[6] == (p.dtype == torch.bfloat16) + 2 * (g.dtype == torch.bfloat16)


def test_adamw_update_matches_jax_over_three_steps():
    pairs = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.bfloat16, torch.float32)]
    sizes = [(5, 7), (13,), (3, 4097), (64,)]
    rng = np.random.default_rng(0)
    names = [f"l{i}" for i in range(len(sizes))]
    tp = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(pairs[i % 3][0])
          for i, (n, s) in enumerate(zip(names, sizes))}
    # copies: JAX may alias a numpy buffer that the port then updates in place
    jp = {n: jnp.asarray(t.float().numpy().copy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32) for n, t in tp.items()}
    ts, js = adamw_init(tp), jax_adamw_init(jp)
    for _ in range(3):
        g_np = {n: rng.standard_normal(s).astype(np.float32) for n, s in zip(names, sizes)}
        tg = {n: torch.from_numpy(g_np[n]).to(pairs[i % 3][1]) for i, n in enumerate(names)}
        jg = {n: jnp.asarray(tg[n].float().numpy()).astype(
            jnp.bfloat16 if tg[n].dtype == torch.bfloat16 else jnp.float32) for n in names}
        adamw_update(tg, ts, tp, 1e-2)
        jp, js = jax_adamw_update(jg, js, jp, 1e-2)
    assert ts.step == int(js.step) == 3
    for n in names:
        for got, want in ((ts.m[n], js.m[n]), (ts.v[n], js.v[n])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
        got, want = tp[n].float().numpy(), np.asarray(jp[n].astype(jnp.float32))
        if tp[n].dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:  # one bf16 step at most
            assert np.all(np.abs(got - want) <= np.abs(want) * 2.0**-7 + 1e-30)
