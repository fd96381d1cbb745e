"""Flash attention: the port's plain versions and its differentiable op
against the JAX package's Pallas kernels (run in interpret mode, as
``tests/test_kernels.py`` runs them) and its dense oracle, on the CPU.

The same inputs, made with numpy (bf16 ones rounded once, by JAX, and
carried over bit for bit), go through both packages.  Tolerances are
those of ``tests/test_kernels.py``: o 2e-5 (f32) and 2e-2 (bf16), lse
1e-5, gradients 2e-4.  The bf16 tensor-core kernels' one change of
numbers, written plainly (``_fwd_bf16_operands``, ``_bwd_bf16_operands``),
is held within the card's bf16 budgets: o 2e-2 and lse 1e-5 for the
forward, 1e-2 x max|g| for the gradients.  Shapes are its rows with the sequence cut to at
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
    attention_delta,
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
from repro_torch.kernels.flash_attention.ref import NEG_INF, _mask, _probs_and_dscores, _scores

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


def _bwd_bf16_operands(q, k, v, do, lse, delta, *, causal=True, window=None, softcap=None):
    """The bf16 backward kernels' arithmetic, written plainly: the f32 p and
    dS of the plain version, rounded to bf16 where the kernels round them (as
    operands of dq = dS k, dk = dS^T q and dv = p^T dO), sums in f32, results
    cast to the inputs' dtype."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    p, ds, dof = _probs_and_dscores(q, k, v, do, lse, delta, causal, window, softcap)
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, k.float()).reshape(q.shape)
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qf)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _within_budget(got, want, names):
    """The card's bf16 gradient tolerance: max |diff| <= 1e-2 x max |want|."""
    for g, w, name in zip(got, want, names):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, name
        err, top = np.abs(g - w).max(), np.abs(w).max()
        assert err <= 1e-2 * top, f"{name}: max |diff| {err:.3e} > 1e-2 x {top:.3e}"


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", BWD_SHAPES, ids=_ids(BWD_SHAPES))
def test_bf16_operand_rounding_within_budget_of_pallas(B, S, Hq, Hkv, hd, causal, window,
                                                      softcap):
    """Rounding p and dS to bf16 (the tensor-core kernels' one change of
    numbers) against the Pallas backward in interpret mode, which keeps them
    in f32, on the same bf16 inputs and JAX's own o and lse."""
    q, k, v, do = _inputs(B, S, S, Hq, Hkv, hd, jnp.bfloat16, seed=7, extra=1)
    opts = dict(causal=causal, window=window, softcap=softcap)
    o, lse = jax_fwd(q, k, v, block_q=128, block_k=128, interpret=True, return_lse=True, **opts)
    want = jax_bwd(q, k, v, o, lse, do, block_q=128, block_k=128, interpret=True, **opts)
    tq, tk, tv, to, tlse, tdo = map(to_torch, (q, k, v, o, lse, do))
    got = _bwd_bf16_operands(tq, tk, tv, tdo, tlse, attention_delta(to, tdo), **opts)
    _within_budget(got, want, ("dq", "dk", "dv"))


ROUNDING_SHAPES = [  # B, S, Hq, Hkv, hd, causal, window, softcap
    (1, 1024, 16, 1, 256, True, 512, None),  # RecurrentGemma's MQA / hd 256, window cut to 512
    (1, 512, 32, 4, 64, True, None, None),  # TinyLlama's layer at batch 1
]


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", ROUNDING_SHAPES,
                         ids=_ids(ROUNDING_SHAPES))
def test_bf16_operand_rounding_within_budget_of_plain(B, S, Hq, Hkv, hd, causal, window,
                                                     softcap):
    """The same rounding against the f32 plain backward at the main paths'
    head layouts (the plain backward is held against the Pallas one above)."""
    q, k, v, do = map(to_torch, _inputs(B, S, S, Hq, Hkv, hd, jnp.bfloat16, seed=8, extra=1))
    opts = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_fwd_ref(q, k, v, **opts)
    delta = attention_delta(o, do)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **opts)
    got = _bwd_bf16_operands(q, k, v, do, lse, delta, **opts)
    _within_budget(got, want, ("dq", "dk", "dv"))


def _fwd_bf16_operands(q, k, v, *, causal=True, window=None, softcap=None):
    """The bf16 forward kernel's arithmetic, written plainly: 64-key tiles in
    order, f32 scores, the running row max m and sum l in f32 (l sums the
    f32 p), p rounded to bf16 as the operand of P V, sums in f32, o = acc /
    l cast to the inputs' dtype, lse = m + log(max(l, 1e-30)).  A row that
    sees no key gets o = 0 and lse = -1e30, as the plain forward gives."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    s, _ = _scores(q, k, softcap)  # (B, Hkv, G, Sq, Sk)
    mask = _mask(Sq, Sk, causal, window, 0, q.device)
    vf = v.float()
    m = torch.full((*s.shape[:-1], 1), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((*s.shape[:-1], hd))
    for k0 in range(0, Sk, 64):
        st, mt = s[..., k0:k0 + 64], mask[:, k0:k0 + 64]
        m_new = torch.maximum(m, torch.where(mt, st, NEG_INF).amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(mt, torch.exp(st - m_new), 0.0)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgst,btkh->bkgsh", p.bfloat16().float(),
                                        vf[:, k0:k0 + 64])
        m = m_new
    o = (acc / torch.where(l == 0.0, 1.0, l)).permute(0, 3, 1, 2, 4).reshape(q.shape)
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]  # (B, Hkv, G, Sq)
    return o.to(q.dtype), lse.reshape(B, Hq, Sq).transpose(1, 2).contiguous()


def _fwd_within_budget(o, lse, want_o, want_lse):
    """The card's bf16 forward tolerance: o 2e-2 element by element and 1e-2
    in per-row relative L2 over the head dim (a row of zeros stays zeros),
    lse 1e-5."""
    o, want_o = (torch.tensor(_np(x)) for x in (o, want_o))
    np.testing.assert_allclose(o.numpy(), want_o.numpy(), rtol=2e-2, atol=2e-2, err_msg="o")
    err, ref = (o - want_o).norm(dim=-1), want_o.norm(dim=-1)
    assert bool((err <= 1e-2 * ref).all()), float((err / ref.clamp(min=1e-30)).max())
    np.testing.assert_allclose(_np(lse), _np(want_lse), rtol=1e-5, atol=1e-5, err_msg="lse")


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", FWD_SHAPES, ids=_ids(FWD_SHAPES))
def test_fwd_bf16_operand_rounding_within_budget_of_pallas(B, S, Hq, Hkv, hd, causal, window,
                                                          softcap):
    """Rounding p to bf16 for P V, over an online softmax of 64-key tiles (the
    tensor-core forward's one change of numbers), against the Pallas forward
    in interpret mode on the same bf16 inputs."""
    q, k, v = _inputs(B, S, S, Hq, Hkv, hd, jnp.bfloat16, seed=9)
    opts = dict(causal=causal, window=window, softcap=softcap)
    jo, jlse = jax_fwd(q, k, v, block_q=128, block_k=128, interpret=True, return_lse=True, **opts)
    o, lse = _fwd_bf16_operands(to_torch(q), to_torch(k), to_torch(v), **opts)
    assert o.dtype == torch.bfloat16 and lse.shape == (B, S, Hq)
    _fwd_within_budget(o, lse, jo, jlse)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", ROUNDING_SHAPES,
                         ids=_ids(ROUNDING_SHAPES))
def test_fwd_bf16_operand_rounding_within_budget_of_plain(B, S, Hq, Hkv, hd, causal, window,
                                                         softcap):
    """The same rounding against the f32 plain forward at the main paths'
    head layouts (the plain forward is held against the Pallas one above)."""
    q, k, v = map(to_torch, _inputs(B, S, S, Hq, Hkv, hd, jnp.bfloat16, seed=10))
    opts = dict(causal=causal, window=window, softcap=softcap)
    want_o, want_lse = flash_attention_fwd_ref(q, k, v, **opts)
    o, lse = _fwd_bf16_operands(q, k, v, **opts)
    _fwd_within_budget(o, lse, want_o, want_lse)


def test_fwd_bf16_operands_rows_that_see_no_key():
    """Rows that see no key (q longer than k, window 64): o = 0 and lse =
    -1e30, as the plain forward gives, and the kernel's tiling agrees with it
    elsewhere."""
    q, k, v = map(to_torch, _inputs(1, 256, 128, 4, 2, 64, jnp.bfloat16, seed=11))
    o, lse = _fwd_bf16_operands(q, k, v, window=64)
    want_o, want_lse = flash_attention_fwd_ref(q, k, v, window=64)
    assert torch.equal(o[:, 191:], torch.zeros_like(o[:, 191:]))
    assert torch.equal(lse[:, 191:], want_lse[:, 191:])
    _fwd_within_budget(o, lse, want_o, want_lse)
