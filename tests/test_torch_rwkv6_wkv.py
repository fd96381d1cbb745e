"""The WKV6 recurrence (kernel B7 and its gradient): the port's plain
versions and its autograd op against the JAX package's, on the CPU.

- ``wkv_ref`` (the sequential loop, the CUDA kernel's plain version)
  against the JAX oracle ``wkv_ref`` and the Pallas kernel in interpret
  mode, at the shapes of ``tests/test_kernels.py`` and at the tolerance it
  uses (2e-4), and at the decode step's (4, 1 and 2, 64, 64) with s0 and
  bf16 r, k, v (where the card runs the step kernel);
- state threading: a run split in two, carried through ``s_final -> s0``,
  matches one full run;
- ``wkv_bwd_ref`` against ``jax.vjp`` of the JAX oracle: both sides work in
  f32 and differ in the order of the sums, so max-abs <= 2e-4 x max(1,
  max|g|);
- the ``WKV6Function`` autograd op by ``torch.autograd.gradcheck`` in f64;
- dispatch: CPU tensors take the plain versions and count ``ref_calls``;
- ``wkv_chunked_ref``, the CPU mirror of the forward kernel's chunked
  arithmetic, against ``wkv_ref`` and the JAX oracle at the same 2e-4 +
  2e-4 |ref| gate: the JAX test shapes and ragged T (1, 15, 17, 65, 200),
  K 32 and 64, with and without s0, f32 and bf16 r/k/v; default, strong,
  extreme (1e-12..1e-6) and near-1 decays, w with exact zeros and a chunk
  whose first 30 steps decay by 1e-30; and in f64 against ``wkv_ref`` in
  f64 at 1e-10;
- two facts about the reference: where a chunk's decay product underflows
  1e-30, the JAX chunked form and the Pallas kernel leave the sequential
  recurrence, and where it falls to ~1e-20 the chunked form's gradient
  overflows; the port follows the sequential recurrence and its gradient;
- ``wkv_bwd_chunked_ref``, the CPU mirror of the backward kernels'
  arithmetic, against ``wkv_bwd_ref`` in f64 at 1e-10 and in f32 at the
  gradient gate, in every decay regime, with and without s0 / ds_final, at T
  below, at and past the chunk boundaries; and against ``jax.vjp`` of the
  JAX oracle.  One more fact, pinned: dw formed as d(log w) / w (as the
  port's sequential backward kernels did) misses the gate wherever the
  decay is small, which is why the chunked backward never divides by w.
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
from repro_torch.kernels.rwkv6_wkv.ref import wkv_bwd_chunked_ref, wkv_chunked_ref

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


#: The chunk-boundary shapes of the chunked mirror: T below, at and past its
#: 8-step sub-chunks and 64-step chunks.
RAGGED = [(1, 1, 2, 32), (1, 8, 2, 64), (2, 9, 2, 32), (2, 15, 2, 64), (1, 17, 2, 32),
          (1, 65, 2, 64), (2, 200, 2, 32)]
DECAYS = ("default", "strong", "extreme", "near1", "zeros", "mixed")


def _decay(mode, B, T, H, K, seed):
    """w for one decay regime: the tests' default ~(0.63, 0.999); strong
    (0.05, 0.3); extreme 10^U(-12, -6); near-1 (0.9999, 0.99999); the default
    with ~30% exact zeros; mixed: 1e-30 in steps 0-29 of every 64, ~0.99 in
    the rest."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (B, T, H, K))
    if mode == "strong":
        w = 0.05 + 0.25 * x
    elif mode == "extreme":
        w = 10.0 ** (-12.0 + 6.0 * x)
    elif mode == "near1":
        w = 0.9999 + 0.00009 * x
    elif mode == "mixed":
        w = 0.985 + 0.01 * x
        w[:, np.arange(T) % 64 < 30] = 1e-30
    else:
        w = np.exp(-np.exp(-6.0 + 5.2 * x))
        if mode == "zeros":
            w[rng.uniform(0.0, 1.0, w.shape) < 0.3] = 0.0
    return w.astype(np.float32)


def _gate_close(got, want):
    """|got - want| <= 2e-4 + 2e-4 |want| everywhere (chip_smoke.py's gate)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    assert np.isfinite(got).all() and (d <= 2e-4 + 2e-4 * np.abs(want)).all(), float(d.max())


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


@pytest.mark.parametrize("T", [1, 2])
def test_plain_matches_jax_at_the_decode_step(T):
    """The decode step's shape, (4, T, 64, 64) with a nonzero s0 and bf16 r,
    k, v, where the card runs the step kernel: ``wkv_ref`` (its plain
    version) against the JAX oracle and the Pallas kernel in interpret
    mode."""
    r, k, v, w, u, s0, _, _ = _inputs(4, T, 64, 64, seed=40 + T)
    rb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (r, k, v))
    to_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    out, s_final = wkv_ref(to_t(rb), to_t(kb), to_t(vb), _t(w), _t(u), _t(s0))
    for want_out, want_s in (jax_wkv_ref(rb, kb, vb, _j(w), _j(u), _j(s0)),
                             wkv_pallas(rb, kb, vb, _j(w), _j(u), _j(s0), chunk=T,
                                        interpret=True)):
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


def _mirror_case(r, k, v, w, u, s0):
    """``wkv_chunked_ref`` against the port's ``wkv_ref`` and the JAX oracle
    on the same inputs (r, k, v torch tensors, f32 or bf16)."""
    out, s_final = wkv_chunked_ref(r, k, v, w, u, s0)
    assert out.shape == r.shape and out.dtype == s_final.dtype == torch.float32
    want_out, want_s = wkv_ref(r, k, v, w, u, s0)
    _gate_close(out, want_out)
    _gate_close(s_final, want_s)
    j = lambda x: None if x is None else jnp.asarray(x.float().numpy())
    jax_out, jax_s = jax_wkv_ref(*map(j, (r, k, v, w, u, s0)))
    _gate_close(out, jax_out)
    _gate_close(s_final, jax_s)


@pytest.mark.parametrize("B,T,H,K", [s[:4] for s in SHAPES] + RAGGED)
@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunked_mirror_matches_sequential_and_jax(B, T, H, K, with_s0, dtype):
    r, k, v, w, u, s0, _, _ = map(_t, _inputs(B, T, H, K, seed=T + K))
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    _mirror_case(r.to(dt), k.to(dt), v.to(dt), w, u, s0 if with_s0 else None)


@pytest.mark.parametrize("mode", DECAYS)
@pytest.mark.parametrize("K", [32, 64])
def test_chunked_mirror_holds_every_decay(mode, K):
    B, T, H = 1, 200, 2
    r, k, v, _, u, s0, _, _ = map(_t, _inputs(B, T, H, K, seed=K))
    _mirror_case(r, k, v, _t(_decay(mode, B, T, H, K, seed=K + 1)), u, s0)


@pytest.mark.parametrize("T,state_only", [(512 + 17, False), (4096 + 17, True)],
                         ids=["T529", "T4113-s_final"])
def test_chunked_mirror_near_one_decays_against_f64(T, state_only):
    """w in (0.9999, 0.99999), bf16 r/k/v: the mirror in f32 holds the gate
    against the sequential recurrence in f64, out and s_final at T 529,
    s_final (which carries the whole walk's decay) at T 4113.  The f32
    sequential loop does not: its rounding adds up over the steps, past the
    gate at T 4113, so the card's near-1 cases are held against f64."""
    B, H, K = 1, 2, 64
    r, k, v, _, u, _, _, _ = map(_t, _inputs(B, T, H, K, seed=5))
    r, k, v = (x.to(torch.bfloat16) for x in (r, k, v))
    w = _t(_decay("near1", B, T, H, K, seed=6))
    out, s_final = wkv_chunked_ref(r, k, v, w, u)
    want_out, want_s = wkv_ref(*(x.double() for x in (r, k, v, w, u)))
    if not state_only:
        _gate_close(out.double(), want_out)
    _gate_close(s_final.double(), want_s)
    if state_only:
        f32_out, _ = wkv_ref(r, k, v, w, u)
        assert float(((f32_out - want_out).abs() / (2e-4 + 2e-4 * want_out.abs())).max()) > 1


@pytest.mark.parametrize("mode", DECAYS)
@pytest.mark.parametrize("K", [32, 64])
def test_chunked_mirror_matches_sequential_in_f64(mode, K):
    """The scheme itself is exact: in f64 it gives the sequential recurrence
    to 1e-10, exact zeros and 1e-30 decays included (the floor e^-88 of a
    zero decay moves nothing above 1e-30)."""
    B, T, H = 2, 130, 2
    r, k, v, _, u, s0, _, _ = (x.double() for x in map(_t, _inputs(B, T, H, K, seed=3)))
    w = _t(_decay(mode, B, T, H, K, seed=4)).double()
    out, s_final = wkv_chunked_ref(r, k, v, w, u, s0)
    want_out, want_s = wkv_ref(r, k, v, w, u, s0)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(s_final.numpy(), want_s.numpy(), rtol=0, atol=1e-10)


#: T below, at and past the backward's 8-step sub-chunks and 64-step chunks.
BWD_T = (1, 8, 9, 63, 64, 65, 200)
GRAD_NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _bwd_case(mode, T, with_state, dtype, seed):
    """B 2, H 2, K 32 inputs in ``dtype`` (torch), w from ``_decay``; s0 and
    ds_final only ``with_state``."""
    B, H, K = 2, 2, 32
    r, k, v, _, u, s0, dout, ds = (torch.from_numpy(x).to(dtype)
                                   for x in _inputs(B, T, H, K, seed=seed))
    w = torch.from_numpy(_decay(mode, B, T, H, K, seed=seed + 1)).to(dtype)
    return (r, k, v, w, u) + ((s0, dout, ds) if with_state else (None, dout, None))


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "s0-ds_final"])
@pytest.mark.parametrize("T", BWD_T)
@pytest.mark.parametrize("mode", DECAYS)
def test_bwd_chunked_mirror_matches_sequential_in_f64(mode, T, with_state):
    """The backward's scheme is exact: in f64 it gives ``wkv_bwd_ref`` to
    1e-10 in every decay regime, exact zeros and 1e-30 decays included."""
    args = _bwd_case(mode, T, with_state, torch.float64, seed=T)
    got = wkv_bwd_chunked_ref(*args)
    want = wkv_bwd_ref(*args)
    assert (got[-1] is None) == (not with_state)
    for name, g, x in zip(GRAD_NAMES, got, want):
        if x is not None:
            assert g.dtype == torch.float64, name
            np.testing.assert_allclose(g.numpy(), x.numpy(), rtol=0, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "s0-ds_final"])
@pytest.mark.parametrize("T", BWD_T)
@pytest.mark.parametrize("mode", DECAYS)
def test_bwd_chunked_mirror_holds_the_gate_in_f32(mode, T, with_state):
    """In f32 the mirror holds every gradient at 2e-4 x max(1, max|g|) of
    ``wkv_bwd_ref`` (in f64, so that the f32 loop's own rounding near 1 does
    not count against it), with no non-finite value."""
    args = _bwd_case(mode, T, with_state, torch.float32, seed=T)
    got = wkv_bwd_chunked_ref(*args)
    want = wkv_bwd_ref(*(None if x is None else x.double() for x in args))
    for name, g, x in zip(GRAD_NAMES, got, want):
        if x is not None:
            assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
            _grad_close(g.double(), x, name)


@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("with_ds", [False, True], ids=["no_ds_final", "ds_final"])
def test_bwd_chunked_mirror_matches_jax_vjp(with_s0, with_ds):
    """The mirror against ``jax.vjp`` of the JAX oracle, as
    ``test_bwd_ref_matches_jax_vjp`` holds ``wkv_bwd_ref``, with T past a
    chunk boundary."""
    B, T, H, K = 2, 96, 2, 32
    r, k, v, w, u, s0, dout, ds = _inputs(B, T, H, K, seed=2)
    ds = ds if with_ds else np.zeros_like(ds)
    if with_s0:
        _, vjp = jax.vjp(jax_wkv_ref, *map(_j, (r, k, v, w, u, s0)))
    else:
        _, vjp = jax.vjp(lambda *a: jax_wkv_ref(*a), *map(_j, (r, k, v, w, u)))
    want = vjp((_j(dout), _j(ds)))
    got = wkv_bwd_chunked_ref(*map(_t, (r, k, v, w, u, s0 if with_s0 else None, dout,
                                        ds if with_ds else None)))
    assert (got[-1] is None) == (not with_s0)
    for name, g, jg in zip(GRAD_NAMES, got, want):
        _grad_close(g, jg, name)


def _dw_through_dlogw(r, k, v, w, dout):
    """dw as the port's sequential backward kernels formed it (f32, no s0,
    no ds_final): d(log w)_t = Σ_{m>=t} (x_{m+1} - k_m ⊙ (dS_m v_m)), with
    x_t = r_t ⊙ (S_{t-1} do_t) and x_T = 0, then dw_t = d(log w)_t / w_t.
    The running sum holds O(1) terms that cancel down to w_t dw_t."""
    B, T, H, K = r.shape
    S = torch.zeros(B, H, K, K)
    x = []
    for t in range(T):
        x.append(r[:, t] * (S @ dout[:, t, :, :, None])[..., 0])
        S = S * w[:, t][..., None] + k[:, t][..., :, None] * v[:, t][..., None, :]
    dS = torch.zeros(B, H, K, K)
    acc, x_next, dw = torch.zeros(B, H, K), torch.zeros(B, H, K), torch.empty(B, T, H, K)
    for t in range(T - 1, -1, -1):
        acc = acc + x_next - k[:, t] * (dS @ v[:, t, :, :, None])[..., 0]
        x_next = x[t]
        dw[:, t] = acc / w[:, t]
        dS = dS * w[:, t][..., None] + r[:, t][..., :, None] * dout[:, t][..., None, :]
    return dw


@pytest.mark.parametrize("mode", ["extreme", "mixed", "zeros"])
def test_dw_through_dlogw_misses_the_gate_where_decays_are_small(mode):
    """Why the chunked backward forms dw as the product of the two states:
    d(log w) / w divides O(1)-sized rounding by w, so at decays of 1e-12 to
    1e-6, of 1e-30 or of exactly 0 it misses the gradient gate by orders of
    magnitude (or is not finite), while ``wkv_bwd_chunked_ref`` holds it."""
    B, T, H, K = 1, 128, 2, 32
    r, k, v, _, u, _, dout, _ = map(_t, _inputs(B, T, H, K, seed=13))
    w = _t(_decay(mode, B, T, H, K, seed=14))
    want = wkv_bwd_ref(*(x.double() for x in (r, k, v, w, u)), None, dout.double())[3]
    gate = GRAD_REL * max(1.0, float(want.abs().max()))
    old = _dw_through_dlogw(r, k, v, w, dout).double()
    assert not (torch.isfinite(old).all() and float((old - want).abs().max()) <= gate)
    new = wkv_bwd_chunked_ref(r, k, v, w, u, None, dout)[3].double()
    assert float((new - want).abs().max()) <= gate
