"""The RG-LRU recurrence (kernel B6 and its gradient): the port's plain
versions against the JAX package's, on the CPU.

- ``rglru_ref`` (the sequential loop, the CUDA kernel's plain version) and
  ``rglru_scan_ref`` (jax.lax.associative_scan's order) against the JAX
  oracle ``rglru_ref`` and the Pallas kernel in interpret mode, at the
  shapes of ``tests/test_kernels.py`` and at the serving decode step's
  (4, 1 and 2, 4096), with and without h0, at the tolerance it uses (1e-5);
- state threading: a run split in two, carried through ``hT -> h0``,
  matches one full run;
- ``rglru_bwd_ref`` against ``jax.vjp`` of the JAX oracle and against
  torch autograd through the port's ``rglru_ref``: both sides work in f32
  and differ only in the order of the products, so max-abs <= 1e-5 x
  max(1, max|g|);
- the ``RGLRUScan`` autograd op by ``torch.autograd.gradcheck`` in f64;
- dispatch: CPU tensors take the plain versions and count ``ref_calls``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.rglru import rglru_pallas
from repro.kernels.rglru import rglru_ref as jax_rglru_ref
from repro.kernels.rglru.ops import rglru as jax_rglru_assoc
from repro_torch.kernels.rglru import (
    RGLRUScan,
    reset_counts,
    rglru,
    rglru_bwd,
    rglru_bwd_ref,
    rglru_fwd,
    rglru_ref,
    rglru_scan_ref,
)

TOL = 1e-5
GRAD_REL = 1e-5
#: tests/test_kernels.py's shapes: B, T, W, Pallas chunk, Pallas block_w
SHAPES = [(2, 64, 128, 16, 128), (1, 128, 256, 32, 128), (1, 256, 512, 128, 256)]
#: the serving decode step's shapes (4 slots, lru_width 4096), one chunk of T
DECODE_SHAPES = [(4, 1, 4096, 1, 512), (4, 2, 4096, 2, 512)]


def _inputs(B, T, W, seed=0, h0=False):
    """``_rglru_inputs`` of tests/test_kernels.py, drawn with numpy:
    a = sigmoid(2 n + 2) in (0, 1), g = 0.5 n, and optionally h0 = n."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-(2.0 * rng.standard_normal((B, T, W)) + 2.0)))).astype(np.float32)
    g = (0.5 * rng.standard_normal((B, T, W))).astype(np.float32)
    s = rng.standard_normal((B, W)).astype(np.float32) if h0 else None
    return a, g, s


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _grad_close(got, want):
    want = np.asarray(want)
    err = float(np.max(np.abs(np.asarray(got) - want)))
    assert err <= GRAD_REL * max(1.0, float(np.max(np.abs(want)))), err


@pytest.mark.parametrize("plain", [rglru_ref, rglru_scan_ref], ids=["sequential", "assoc"])
@pytest.mark.parametrize("B,T,W,chunk,block_w", SHAPES + DECODE_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_plain_matches_jax_ref_and_pallas_interpret(plain, B, T, W, chunk, block_w, with_h0):
    a, g, h0 = _inputs(B, T, W, seed=T, h0=with_h0)
    h, hT = plain(_t(a), _t(g), _t(h0))
    for want_h, want_hT in (jax_rglru_ref(_j(a), _j(g), _j(h0)),
                            rglru_pallas(_j(a), _j(g), _j(h0), chunk=chunk, block_w=block_w,
                                         interpret=True)):
        _close(h, want_h)
        _close(hT, want_hT)
    assert torch.equal(hT, h[:, -1])


def test_assoc_order_is_jax_associative_scan():
    """rglru_scan_ref reproduces the JAX fallback op's associative scan bit
    for bit (the same products in the same order), h0 folded in alike."""
    a, g, h0 = _inputs(2, 96, 64, seed=5, h0=True)
    h, hT = rglru_scan_ref(_t(a), _t(g), _t(h0))
    jh, jT = jax_rglru_assoc(_j(a), _j(g), _j(h0), use_pallas=False)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(hT.numpy(), np.asarray(jT))


@pytest.mark.parametrize("plain", [rglru_ref, rglru_scan_ref], ids=["sequential", "assoc"])
def test_state_threading(plain):
    a, g, _ = _inputs(1, 128, 128, seed=1)
    a, g = _t(a), _t(g)
    h_full, hT_full = plain(a, g)
    h_a, s_a = plain(a[:, :64], g[:, :64])
    h_b, s_b = plain(a[:, 64:], g[:, 64:], s_a)
    _close(torch.cat([h_a, h_b], dim=1), h_full)
    _close(s_b, hT_full)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("with_dhT", [False, True], ids=["no_dhT", "dhT"])
def test_bwd_ref_matches_jax_vjp(with_h0, with_dhT):
    B, T, W = 2, 64, 128
    a, g, h0 = _inputs(B, T, W, seed=2, h0=with_h0)
    rng = np.random.default_rng(3)
    dh = rng.standard_normal((B, T, W)).astype(np.float32)
    dhT = rng.standard_normal((B, W)).astype(np.float32) if with_dhT else np.zeros((B, W), np.float32)
    if with_h0:
        _, vjp = jax.vjp(jax_rglru_ref, _j(a), _j(g), _j(h0))
        ja, jg, jh0 = vjp((_j(dh), _j(dhT)))
    else:
        _, vjp = jax.vjp(lambda x, y: jax_rglru_ref(x, y), _j(a), _j(g))
        (ja, jg), jh0 = vjp((_j(dh), _j(dhT))), None
    h, _ = rglru_ref(_t(a), _t(g), _t(h0))
    da, dg, dh0 = rglru_bwd_ref(_t(a), h, _t(h0), _t(dh), _t(dhT) if with_dhT else None)
    _grad_close(da, ja)
    _grad_close(dg, jg)
    assert (dh0 is None) == (not with_h0)
    if with_h0:
        _grad_close(dh0, jh0)


def test_bwd_ref_matches_torch_autograd():
    a, g, h0 = (x.requires_grad_() for x in map(_t, _inputs(2, 48, 32, seed=4, h0=True)))
    rng = np.random.default_rng(6)
    dh, dhT = _t(rng.standard_normal((2, 48, 32)).astype(np.float32)), _t(
        rng.standard_normal((2, 32)).astype(np.float32))
    h, hT = rglru_ref(a, g, h0)
    torch.autograd.backward((h, hT), (dh, dhT))
    da, dg, dh0 = rglru_bwd_ref(a.detach(), h.detach(), h0.detach(), dh, dhT)
    for got, want in ((da, a.grad), (dg, g.grad), (dh0, h0.grad)):
        _grad_close(got, want)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rglru_op_gradcheck_f64(with_h0):
    gen = torch.Generator().manual_seed(0)
    a = (0.1 + 0.8 * torch.rand(2, 7, 3, generator=gen, dtype=torch.float64)).requires_grad_()
    g = torch.randn(2, 7, 3, generator=gen, dtype=torch.float64).requires_grad_()
    inputs = (a, g)
    if with_h0:
        inputs += (torch.randn(2, 3, generator=gen, dtype=torch.float64).requires_grad_(),)
    assert torch.autograd.gradcheck(lambda *x: rglru(*x), inputs)
    # only h used: hT's cotangent arrives as None and is taken as 0
    assert torch.autograd.gradcheck(lambda *x: rglru(*x)[0], inputs)


def test_cpu_tensors_take_the_plain_versions():
    reset_counts()
    a, g, _ = (_t(x) for x in _inputs(1, 16, 8))
    a.requires_grad_()
    h, hT = rglru(a, g)
    want_h, want_hT = rglru_ref(a.detach(), g)
    assert torch.equal(h.detach(), want_h) and torch.equal(hT.detach(), want_hT)
    h.sum().backward()
    assert (rglru_fwd.ref_calls, rglru_bwd.ref_calls) == (1, 1)
    assert (rglru_fwd.launches, rglru_bwd.launches) == (0, 0)
    assert isinstance(h.grad_fn, RGLRUScan._backward_cls)
    reset_counts()


def test_wrappers_check_their_inputs():
    a, g, _ = (_t(x) for x in _inputs(1, 16, 8))
    with pytest.raises(ValueError, match="expected"):
        rglru_fwd(a, g[:, :8])
    with pytest.raises(ValueError, match="h0"):
        rglru_fwd(a, g, torch.zeros(1, 9))
    with pytest.raises(ValueError, match=r"\(B, T, W\)"):
        rglru_fwd(a[0], g[0])
    with pytest.raises(ValueError, match="one device"):
        rglru_bwd(a, a, None, torch.zeros(1, 16, 8, device="meta"))
