"""The WKV6 recurrence (kernel B7 and its gradient): the port's plain
versions and its autograd op against the JAX package's, on the CPU.

- ``wkv_ref`` (the sequential loop, the CUDA kernel's plain version)
  against the JAX oracle ``wkv_ref`` and the Pallas kernel in interpret
  mode, at the shapes of ``tests/test_kernels.py`` and at the tolerance it
  uses (2e-4);
- state threading: a run split in two, carried through ``s_final -> s0``,
  matches one full run;
- ``wkv_bwd_ref`` against ``jax.vjp`` of the JAX oracle: both sides work in
  f32 and differ in the order of the sums, so max-abs <= 2e-4 x max(1,
  max|g|);
- the ``WKV6Function`` autograd op by ``torch.autograd.gradcheck`` in f64;
- dispatch: CPU tensors take the plain versions and count ``ref_calls``;
- two facts about the reference: where a chunk's decay product underflows
  1e-30, the JAX chunked form and the Pallas kernel leave the sequential
  recurrence, and where it falls to ~1e-20 the chunked form's gradient
  overflows; the port follows the sequential recurrence and its gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.rwkv6_wkv import wkv_pallas
from repro.kernels.rwkv6_wkv import wkv_ref as jax_wkv_ref
from repro.models.rwkv6 import wkv_chunked
from repro_torch.kernels.rwkv6_wkv import (
    WKV6Function,
    reset_counts,
    wkv,
    wkv_bwd,
    wkv_bwd_ref,
    wkv_fwd,
    wkv_ref,
)

TOL = 2e-4
GRAD_REL = 2e-4
#: tests/test_kernels.py's shapes: B, T, H, K, Pallas chunk
SHAPES = [(2, 64, 2, 32, 16), (1, 128, 4, 64, 32), (1, 256, 1, 64, 128), (2, 96, 2, 32, 32)]


def _inputs(B, T, H, K, seed=0, w_range=None):
    """``_wkv_inputs`` of tests/test_kernels.py, drawn with numpy: r, k, v
    standard normal, w = exp(-exp(U(-6, -0.8))) in ~(0.63, 0.999) (or
    uniform in ``w_range``), u = 0.5 n; then s0, and the cotangents dout and
    ds_final, standard normal."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    r, k, v = n(B, T, H, K), n(B, T, H, K), n(B, T, H, K)
    if w_range is None:
        w = np.exp(-np.exp(rng.uniform(-6.0, -0.8, (B, T, H, K)))).astype(np.float32)
    else:
        w = rng.uniform(*w_range, (B, T, H, K)).astype(np.float32)
    u = 0.5 * n(H, K)
    return r, k, v, w, u, n(B, H, K, K), n(B, T, H, K), n(B, H, K, K)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _grad_close(got, want, name=""):
    want = np.asarray(want)
    err = float(np.max(np.abs(np.asarray(got) - want)))
    assert err <= GRAD_REL * max(1.0, float(np.max(np.abs(want)))), (name, err)


@pytest.mark.parametrize("B,T,H,K,chunk", SHAPES)
@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
def test_plain_matches_jax_ref_and_pallas_interpret(B, T, H, K, chunk, with_s0):
    r, k, v, w, u, s0, _, _ = _inputs(B, T, H, K, seed=T)
    s0 = s0 if with_s0 else None
    out, s_final = wkv_ref(*map(_t, (r, k, v, w, u, s0)))
    assert out.dtype == s_final.dtype == torch.float32
    for want_out, want_s in (jax_wkv_ref(*map(_j, (r, k, v, w, u, s0))),
                             wkv_pallas(*map(_j, (r, k, v, w, u, s0)), chunk=chunk,
                                        interpret=True)):
        _close(out, want_out)
        _close(s_final, want_s)


def test_plain_takes_bf16_inputs_as_the_reference_does():
    """bf16 r, k, v are read as f32, as the JAX oracle casts them."""
    r, k, v, w, u, *_ = _inputs(2, 96, 2, 32, seed=4)
    rb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (r, k, v))
    to_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    out, s_final = wkv_ref(to_t(rb), to_t(kb), to_t(vb), _t(w), _t(u))
    want_out, want_s = jax_wkv_ref(rb, kb, vb, _j(w), _j(u))
    _close(out, want_out)
    _close(s_final, want_s)


def test_state_threading():
    r, k, v, w, u, *_ = map(_t, _inputs(1, 128, 2, 32, seed=1))
    out, s_final = wkv_ref(r, k, v, w, u)
    h = 64
    out_a, s_a = wkv_ref(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u)
    out_b, s_b = wkv_ref(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s_a)
    _close(torch.cat([out_a, out_b], dim=1), out)
    _close(s_b, s_final)


@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("with_ds", [False, True], ids=["no_ds_final", "ds_final"])
def test_bwd_ref_matches_jax_vjp(with_s0, with_ds):
    B, T, H, K = 2, 96, 2, 32
    r, k, v, w, u, s0, dout, ds = _inputs(B, T, H, K, seed=2)
    ds = ds if with_ds else np.zeros_like(ds)
    if with_s0:
        _, vjp = jax.vjp(jax_wkv_ref, *map(_j, (r, k, v, w, u, s0)))
    else:
        _, vjp = jax.vjp(lambda *a: jax_wkv_ref(*a), *map(_j, (r, k, v, w, u)))
    want = vjp((_j(dout), _j(ds)))
    got = wkv_bwd_ref(*map(_t, (r, k, v, w, u, s0 if with_s0 else None, dout,
                                ds if with_ds else None)))
    assert (got[-1] is None) == (not with_s0)
    for name, g, jg in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        _grad_close(g, jg, name)


@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
def test_wkv_op_gradcheck_f64(with_s0):
    gen = torch.Generator().manual_seed(0)
    B, T, H, K = 2, 6, 2, 3
    n = lambda *shape: torch.randn(*shape, generator=gen, dtype=torch.float64)
    w = (0.2 + 0.75 * torch.rand(B, T, H, K, generator=gen, dtype=torch.float64))
    inputs = [n(B, T, H, K), n(B, T, H, K), n(B, T, H, K), w, n(H, K)]
    inputs.append(n(B, H, K, K) if with_s0 else None)
    inputs = [x if x is None else x.requires_grad_() for x in inputs]
    assert torch.autograd.gradcheck(lambda *x: wkv(*x), inputs)
    # only out used: s_final's cotangent arrives as None and is taken as 0
    assert torch.autograd.gradcheck(lambda *x: wkv(*x)[0], inputs)


def test_cpu_tensors_take_the_plain_versions():
    reset_counts()
    r, k, v, w, u, *_ = map(_t, _inputs(1, 16, 2, 32))
    r.requires_grad_()
    out, s_final = wkv(r, k, v, w, u)
    want_out, want_s = wkv_ref(r.detach(), k, v, w, u)
    assert torch.equal(out.detach(), want_out) and torch.equal(s_final.detach(), want_s)
    out.sum().backward()
    assert (wkv_fwd.ref_calls, wkv_bwd.ref_calls) == (1, 1)
    assert (wkv_fwd.launches, wkv_bwd.launches) == (0, 0)
    assert isinstance(out.grad_fn, WKV6Function._backward_cls)
    reset_counts()


def test_wkv_op_returns_gradients_in_the_input_dtypes():
    r, k, v, w, u, *_ = map(_t, _inputs(1, 16, 2, 32))
    rb, kb, vb = (x.to(torch.bfloat16).requires_grad_() for x in (r, k, v))
    w.requires_grad_()
    u.requires_grad_()
    out, _ = wkv(rb, kb, vb, w, u)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert rb.grad.dtype == kb.grad.dtype == vb.grad.dtype == torch.bfloat16
    assert w.grad.dtype == u.grad.dtype == torch.float32


def test_wrappers_check_their_inputs():
    r, k, v, w, u, s0, dout, _ = map(_t, _inputs(1, 16, 2, 32))
    with pytest.raises(ValueError, match="expected"):
        wkv_fwd(r, k[:, :8], v, w, u)
    with pytest.raises(ValueError, match="u is"):
        wkv_fwd(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="s0"):
        wkv_fwd(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match=r"\(B, T, H, K\)"):
        wkv_fwd(r[0], k[0], v[0], w[0], u)
    with pytest.raises(ValueError, match="one device"):
        wkv_bwd(r, k, v, w, u, None, torch.zeros(1, 16, 2, 32, device="meta"))


def test_reference_chunked_form_breaks_where_a_chunk_decay_underflows():
    """A fact about the reference, pinned: with decays in (0.3, 0.6) over a
    128-step chunk, the product of a chunk's decays falls far below 1e-30,
    and the ``k / max(W_inc, 1e-30)`` factorisation of the JAX chunked form
    (``wkv_chunked``) and of the Pallas kernel no longer gives the sequential
    recurrence: both are off by more than 1.  The port's ``wkv_ref`` follows
    the sequential recurrence (the JAX ``wkv_ref``) to 2e-4."""
    r, k, v, w, u, *_ = _inputs(1, 256, 2, 32, seed=11, w_range=(0.3, 0.6))
    args = tuple(map(_j, (r, k, v, w, u)))
    want_out, want_s = jax_wkv_ref(*args)
    for out, _ in (wkv_chunked(*args, chunk=128), wkv_pallas(*args, chunk=128, interpret=True)):
        assert float(jnp.max(jnp.abs(out - want_out))) > 1.0
    # at a 16-step chunk the decay product stays above 1e-30: the forms agree
    _close(wkv_chunked(*args, chunk=16)[0], want_out)
    out, s_final = wkv_ref(*map(_t, (r, k, v, w, u)))
    _close(out, want_out)
    _close(s_final, want_s)


def test_reference_chunked_gradient_overflows_where_a_chunk_decay_is_tiny():
    """A second fact about the reference, pinned: the chunked form's
    gradient goes through ``k / W_inc``, so through ``1 / W_inc²``, which
    overflows f32 once a chunk's decay product falls to ~1e-20, far above
    the forward's 1e-30 clamp.  With decays in (0.03, 0.08) and 16-step
    chunks (the reduced config's ``rec_chunk``) ``jax.vjp`` of
    ``wkv_chunked`` gives a non-finite dw; the port's ``wkv_bwd_ref`` matches
    ``jax.vjp`` of the sequential ``wkv_ref``."""
    r, k, v, w, u, _, dout, _ = _inputs(1, 64, 2, 32, seed=12, w_range=(0.03, 0.08))
    args = tuple(map(_j, (r, k, v, w, u)))
    zero = jnp.zeros((1, 2, 32, 32), jnp.float32)
    _, vjp = jax.vjp(lambda *a: wkv_chunked(*a, chunk=16), *args)
    assert not np.isfinite(np.asarray(vjp((_j(dout), zero))[3])).all()
    _, vjp = jax.vjp(lambda *a: jax_wkv_ref(*a), *args)
    want = vjp((_j(dout), zero))
    got = wkv_bwd_ref(*map(_t, (r, k, v, w, u)), None, _t(dout))
    for name, g, jg in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert np.isfinite(np.asarray(jg)).all()
        _grad_close(g, jg, name)
