"""Flash attention: the port's plain versions and its differentiable op
against the JAX package's Pallas kernels (run in interpret mode, as
``tests/test_kernels.py`` runs them) and its dense oracle, on the CPU.

The same inputs, made with numpy (bf16 ones rounded once, by JAX, and
carried over bit for bit), go through both packages.  Tolerances are
those of ``tests/test_kernels.py``: o 2e-5 (f32) and 2e-2 (bf16), lse
1e-5, gradients 2e-4.  Shapes are its rows with the sequence cut to at
most 256, so that interpret mode stays fast, plus the reduced model's
head dim 32.  The CUDA kernels themselves are held against these plain
versions on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_env import to_torch
from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_fwd
from repro.kernels.flash_attention.kernel_bwd import flash_attention_bwd as jax_bwd
from repro.kernels.flash_attention.ops import flash_attention_train as jax_train
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import (
    attention_ref,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    flash_attention_fwd_ref,
    flash_attention_train,
    reset_counts,
)

FWD_SHAPES = [  # B, S, Hq, Hkv, hd, causal, window, softcap
    (2, 256, 4, 2, 64, True, None, None),
    (1, 256, 8, 8, 128, True, None, None),
    (2, 256, 4, 1, 64, True, 128, None),
    (1, 256, 2, 2, 64, True, None, 50.0),
    (1, 256, 4, 2, 64, False, None, None),
    (1, 256, 6, 2, 128, True, 128, 30.0),  # everything at once
    (1, 128, 4, 4, 256, True, None, None),  # gemma head_dim
    (2, 64, 4, 2, 32, True, None, None),  # the reduced model's head_dim
]
BWD_SHAPES = [
    (1, 256, 4, 2, 64, True, None, None),
    (1, 256, 4, 4, 64, False, None, None),
    (1, 256, 2, 1, 64, True, 128, None),
    (1, 256, 2, 2, 64, True, None, 50.0),
    (1, 256, 6, 2, 128, True, 128, 30.0),
]
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _ids(shapes):
    return ["-".join(str(x) for x in s) for s in shapes]


def _inputs(B, Sq, Sk, Hq, Hkv, hd, dtype=jnp.float32, seed=0, extra=0):
    """q, k, v (and ``extra`` more q-shaped arrays) as JAX arrays of
    ``dtype``, from one numpy generator."""
    rng = np.random.default_rng(seed)
    shapes = [(B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)] + [(B, Sq, Hq, hd)] * extra
    return [jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(dtype) for s in shapes]


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else jnp.float32(x))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", FWD_SHAPES, ids=_ids(FWD_SHAPES))
def test_fwd_ref_matches_pallas_interpret(B, S, Hq, Hkv, hd, causal, window, softcap, dtype):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    q, k, v = _inputs(B, S, S, Hq, Hkv, hd, jdt)
    opts = dict(causal=causal, window=window, softcap=softcap)
    jo, jlse = jax_fwd(q, k, v, block_q=128, block_k=128, interpret=True, return_lse=True, **opts)
    o, lse = flash_attention_fwd_ref(to_torch(q), to_torch(k), to_torch(v), **opts)
    assert o.dtype == to_torch(q).dtype and lse.shape == (B, S, Hq) and lse.dtype == torch.float32
    tol = 2e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(_np(o), _np(jo), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", BWD_SHAPES, ids=_ids(BWD_SHAPES))
def test_bwd_ref_matches_pallas_interpret(B, S, Hq, Hkv, hd, causal, window, softcap):
    """The same (q, k, v, o, lse, dO) into both backwards: JAX's o and lse
    from its own forward."""
    q, k, v, do = _inputs(B, S, S, Hq, Hkv, hd, seed=1, extra=1)
    opts = dict(causal=causal, window=window, softcap=softcap)
    o, lse = jax_fwd(q, k, v, block_q=128, block_k=128, interpret=True, return_lse=True, **opts)
    want = jax_bwd(q, k, v, o, lse, do, block_q=128, block_k=128, interpret=True, **opts)
    got = flash_attention_bwd_ref(*map(to_torch, (q, k, v, o, lse, do)), **opts)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", BWD_SHAPES, ids=_ids(BWD_SHAPES))
def test_train_op_grads_match_jax_flash_attention_train(B, S, Hq, Hkv, hd, causal, window,
                                                        softcap):
    """Gradients of sum(o * w) through the port's autograd op (its plain
    versions on the CPU) against the JAX package's custom-VJP op."""
    q, k, v, w = _inputs(B, S, S, Hq, Hkv, hd, seed=2, extra=1)

    def jax_loss(q, k, v):
        return jnp.sum(jax_train(q, k, v, causal, window, softcap, True) * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (to_torch(x).requires_grad_() for x in (q, k, v))
    reset_counts()
    o = flash_attention_train(tq, tk, tv, causal=causal, window=window, softcap=softcap)
    (o * to_torch(w)).sum().backward()
    assert flash_attention_fwd.ref_calls == flash_attention_dq.ref_calls == 1
    assert flash_attention_dkv.ref_calls == 1
    assert flash_attention_fwd.launches == flash_attention_dq.launches == 0
    for g, w_, name in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g), _np(w_), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("Sq,Sk,causal,window,softcap", [
    (128, 128, True, None, None),
    (128, 128, False, 32, 20.0),
    (256, 128, True, 64, None),  # rows 191.. see no key
], ids=["causal", "window-softcap", "fully-masked-rows"])
def test_attention_ref_matches_jax(Sq, Sk, causal, window, softcap):
    q, k, v = _inputs(2, Sq, Sk, 4, 2, 32, seed=3)
    opts = dict(causal=causal, window=window, softcap=softcap)
    want = jax_attention_ref(q, k, v, **opts)
    got = attention_ref(to_torch(q), to_torch(k), to_torch(v), **opts)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_fully_masked_rows_give_zero():
    """q longer than k with a window of 64: rows 191 and up see no key.  The
    port's forward follows ``attention_ref`` (o = 0 there); the Pallas
    forward gives such a row the mean of v over the block (its -1e30 mask
    value becomes exp(0) = 1 weights) and agrees everywhere else."""
    q, k, v = _inputs(1, 256, 128, 2, 1, 64, seed=4)
    opts = dict(causal=True, window=64)
    o, lse = flash_attention_fwd_ref(to_torch(q), to_torch(k), to_torch(v), **opts)
    ref = attention_ref(to_torch(q), to_torch(k), to_torch(v), **opts)
    assert torch.equal(o[:, 191:], torch.zeros_like(o[:, 191:]))
    assert bool((lse[:, 191:] == -1e30).all()) and bool((lse[:, :191] > -1e3).all())
    np.testing.assert_allclose(_np(o), _np(ref), rtol=2e-5, atol=2e-5)
    pallas = np.asarray(jax_fwd(q, k, v, block_q=128, block_k=128, interpret=True, **opts))
    np.testing.assert_allclose(pallas[:, :191], _np(o)[:, :191], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pallas[0, 200, 0], np.asarray(v)[0, :, 0].mean(axis=0),
                               rtol=1e-5, atol=1e-6)


def test_train_op_saves_only_its_residuals_and_takes_a_strided_cotangent():
    """The forward saves (q, k, v, o, lse) and nothing of size Sq x Sk; a
    cotangent that reaches backward strided gives the same gradients."""
    q, k, v = (to_torch(x).requires_grad_() for x in _inputs(1, 64, 64, 4, 2, 32, seed=5))
    o = flash_attention_train(q, k, v)
    saved = o.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        (1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32), (1, 64, 4, 32), (1, 64, 4)]
    w = torch.randn(1, 4, 64, 32, generator=torch.Generator().manual_seed(0))
    (o.transpose(1, 2) * w).sum().backward()  # the cotangent of o is w transposed
    strided = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    flash_attention_train(q, k, v).backward(w.transpose(1, 2).contiguous())
    for a, b in zip(strided, (q.grad, k.grad, v.grad)):
        assert torch.equal(a, b)


def test_dispatch_follows_the_device_and_counts():
    q, k, v, do = map(to_torch, _inputs(1, 64, 64, 2, 1, 32, seed=6, extra=1))
    reset_counts()
    o, lse = flash_attention_fwd(q, k, v, return_lse=True)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do)
    for fn in (flash_attention_fwd, flash_attention_dq, flash_attention_dkv):
        assert (fn.launches, fn.ref_calls) == (0, 1), fn.__name__
    want = flash_attention_bwd_ref(q, k, v, o, lse, do)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="window"):
        flash_attention_fwd(q, k, v, window=0)
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention_fwd(q[..., :16], k, v)
