"""The CUDA kernels against their plain PyTorch versions, on the card.

comm_pack: bit-identical arena, residuals and unpacked parts over part
dtype {f32, bf16, mixed} x wire {f32, bf16} x EF {off, on}, at odd sizes
and offsets, sources that are not 16-byte aligned, and scale 1/3.

flash_attention: forward, dQ and dK/dV at the full-width main path's
shape (B 4, S 512, 32 query / 4 KV heads, hd 64) in f32 and bf16, at the
tolerances of ``tests/test_kernels.py`` (o 2e-5 f32 / 2e-2 bf16, lse
1e-5, f32 gradients 2e-4; bf16 gradients 1e-2 x max|g|: both sides work
in f32 from the same bf16 inputs and round the result once); rows that
see no key give 0; two runs give the same bits; and one reduced training
step with the flash kernels gives bitwise the same parameters for the
``post`` and ``dag`` issue orders.

rglru: the forward and backward kernels against their plain versions
(the sequential loop and its reverse) at the JAX tests' first shape, a
ragged one and the main path's (1, 4096, 4096), with and without h0:
h / hT within 1e-5 (the tolerance of ``tests/test_kernels.py``), gradients
within 1e-5 x max(1, max|g|) (the kernels reassociate the carry across
time chunks; the plain versions do not); hT is exactly h[:, -1], two runs
give the same bits, a run split at T/2 and threaded through hT -> h0
matches one run; and reduced RecurrentGemma trains bitwise equal under
``post`` and ``dag``.

rwkv6_wkv: the forward and backward kernels against their plain versions
(the sequential loop and its reverse walk) at the JAX tests' four shapes
and the main path's (1, 4096, 64, 64), with and without s0 and ds_final,
r/k/v in f32 and bf16: out / s_final within 2e-4 (the tolerance of
``tests/test_kernels.py``), gradients within 2e-4 x max(1, max|g|); strong
decays (w in (0.05, 0.3)); a run split at T/2 and threaded through
s_final -> s0 matches one run; two runs give the same bits; the autograd op
launches both kernels; and reduced RWKV6 trains bitwise equal under
``post`` and ``dag``.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU interpret mode):
they carry the ``cuda`` marker and skip elsewhere.  The file imports no
JAX, so it runs on a machine that has only the port's dependencies:
``python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from _torch_env import bits, require_cuda
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import rwkv6_wkv as wk
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


MAIN_SHAPE = (4, 512, 32, 4, 64)  # B, S, Hq, Hkv, hd of full-width TinyLlama-1.1B


def _qkv(B, Sq, Sk, Hq, Hkv, hd, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, generator=g, device=device).to(dtype)
    return mk(B, Sq, Hq, hd), mk(B, Sk, Hkv, hd), mk(B, Sk, Hkv, hd), mk(B, Sq, Hq, hd)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_flash_kernels_match_plain_at_main_path_shape(dtype):
    dev = require_cuda()
    B, S, Hq, Hkv, hd = MAIN_SHAPE
    q, k, v, do = _qkv(B, S, S, Hq, Hkv, hd, TORCH_DT[dtype], dev)
    fa.reset_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    want_o, want_lse = fa.flash_attention_fwd_ref(q, k, v)
    delta = fa.attention_delta(want_o, do)
    dq = fa.flash_attention_dq(q, k, v, do, want_lse, delta)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, want_lse, delta)
    torch.cuda.synchronize()
    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv):
        assert (fn.launches, fn.ref_calls) == (1, 0), fn.__name__
    tol = 2e-2 if dtype == "bf16" else 2e-5
    torch.testing.assert_close(o.float(), want_o.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    want_dq = fa.flash_attention_dq_ref(q, k, v, do, want_lse, delta)
    want_dk, want_dv = fa.flash_attention_dkv_ref(q, k, v, do, want_lse, delta)
    for got, want, name in ((dq, want_dq, "dq"), (dk, want_dk, "dk"), (dv, want_dv, "dv")):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if dtype == "bf16":
            assert _rel(got, want) <= 1e-2, name
        else:
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4, msg=name)


@pytest.mark.cuda
def test_cuda_flash_rows_that_see_no_key_are_zero_and_runs_repeat_bitwise():
    dev = require_cuda()
    q, k, v, do = _qkv(1, 256, 128, 4, 2, 64, torch.float32, dev, seed=1)
    o, lse = fa.flash_attention_fwd(q, k, v, window=64, return_lse=True)
    torch.testing.assert_close(o, fa.attention_ref(q, k, v, window=64), rtol=2e-5, atol=2e-5)
    assert torch.equal(o[:, 191:], torch.zeros_like(o[:, 191:]))
    grads = [fa.flash_attention_bwd(q, k, v, o, lse, do, window=64) for _ in range(2)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert torch.equal(fa.flash_attention_fwd(q, k, v, window=64), o)


@pytest.mark.cuda
def test_cuda_flash_rejects_what_the_kernels_do_not_take():
    dev = require_cuda()
    q, k, v, _ = _qkv(1, 64, 64, 2, 1, 48, torch.float32, dev)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v, _ = _qkv(1, 64, 64, 2, 1, 64, torch.float16, dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q, k, v)


@pytest.mark.cuda
def test_cuda_reduced_step_post_and_dag_bitwise_equal_with_flash():
    require_cuda()
    from repro_torch.launch.train import run

    params = []
    for order in ("post", "dag"):
        res = run(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "2", "--batch", "2",
                   "--seq", "64", "--fuse", "arena", "--issue-order", order], quiet=True)
        params.append((res.losses, {n: p.detach().cpu() for n, p in res.model.named_parameters()}))
    assert params[0][0] == params[1][0]
    for n, p in params[0][1].items():
        assert torch.equal(p, params[1][1][n]), n


def _rglru_inputs(B, T, W, device, seed=0):
    """As tests/test_kernels.py draws them: a = sigmoid(2 n + 2), g = 0.5 n;
    h0 = n, and a cotangent dh = n and dhT = n."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    return (torch.sigmoid(2.0 * n(B, T, W) + 2.0), 0.5 * n(B, T, W), n(B, W), n(B, T, W),
            n(B, W))


def _grad_close(got, want, name):
    err = float((got - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("shape", [(2, 64, 128), (3, 300, 40), (1, 4096, 4096)],
                         ids=["jax-test", "ragged", "main-path"])
def test_cuda_rglru_kernels_match_plain(shape, with_h0):
    dev = require_cuda()
    a, g, h0, dh, dhT = _rglru_inputs(*shape, dev)
    h0 = h0 if with_h0 else None
    rg.reset_counts()
    h, hT = rg.rglru_fwd(a, g, h0)
    da, dg, dh0 = rg.rglru_bwd(a, h, h0, dh, dhT)
    torch.cuda.synchronize()
    assert (rg.rglru_fwd.launches, rg.rglru_bwd.launches) == (1, 1)
    assert (rg.rglru_fwd.ref_calls, rg.rglru_bwd.ref_calls) == (0, 0)
    want_h, want_hT = rg.rglru_ref(a, g, h0)
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hT, want_hT, rtol=1e-5, atol=1e-5)
    assert torch.equal(hT, h[:, -1])
    want_da, want_dg, want_dh0 = rg.rglru_bwd_ref(a, h, h0, dh, dhT)
    _grad_close(da, want_da, "da")
    _grad_close(dg, want_dg, "dg")
    assert (dh0 is None) == (h0 is None)
    if h0 is not None:
        _grad_close(dh0, want_dh0, "dh0")
    h2, _ = rg.rglru_fwd(a, g, h0)
    da2, dg2, _ = rg.rglru_bwd(a, h, h0, dh, dhT)
    assert torch.equal(h2, h) and torch.equal(da2, da) and torch.equal(dg2, dg)


@pytest.mark.cuda
def test_cuda_rglru_state_threading_and_autograd():
    dev = require_cuda()
    a, g, _, dh, _ = _rglru_inputs(1, 1024, 256, dev, seed=3)
    h_full, hT_full = rg.rglru_fwd(a, g)
    h_a, s_a = rg.rglru_fwd(a[:, :512], g[:, :512])
    h_b, s_b = rg.rglru_fwd(a[:, 512:], g[:, 512:], s_a)
    torch.testing.assert_close(torch.cat([h_a, h_b], dim=1), h_full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_b, hT_full, rtol=1e-5, atol=1e-5)
    # the autograd op launches the forward kernel, then the backward kernel
    rg.reset_counts()
    ag = a.clone().requires_grad_()
    h, _ = rg.rglru(ag, g)
    h.backward(dh)
    assert (rg.rglru_fwd.launches, rg.rglru_bwd.launches) == (1, 1)
    want_da, _, _ = rg.rglru_bwd_ref(a, h.detach(), None, dh)
    _grad_close(ag.grad, want_da, "da")


@pytest.mark.cuda
def test_cuda_rglru_rejects_what_the_kernels_do_not_take():
    dev = require_cuda()
    a, g, h0, _, _ = _rglru_inputs(1, 64, 32, dev)
    with pytest.raises(TypeError, match="float32"):
        rg.rglru_fwd(a.to(torch.bfloat16), g.to(torch.bfloat16))
    with pytest.raises(ValueError, match="one device"):
        rg.rglru_fwd(a, g, h0.cpu())


@pytest.mark.cuda
def test_cuda_reduced_recurrentgemma_post_and_dag_bitwise_equal():
    require_cuda()
    from repro_torch.launch.train import run

    params = []
    for order in ("post", "dag"):
        res = run(["--arch", "recurrentgemma-9b", "--reduced", "--steps", "2", "--batch", "2",
                   "--seq", "128", "--fuse", "arena", "--policy", "wfbp",
                   "--issue-order", order], quiet=True)
        params.append((res.losses, {n: p.detach().cpu() for n, p in res.model.named_parameters()}))
    assert params[0][0] == params[1][0]
    for n, p in params[0][1].items():
        assert torch.equal(p, params[1][1][n]), n


def _wkv_inputs(B, T, H, K, device, seed=0, dtype=torch.float32, w_range=None):
    """As tests/test_kernels.py draws them: r, k, v = n (in ``dtype``),
    w = exp(-exp(U(-6, -0.8))) (or uniform in ``w_range``), u = 0.5 n; s0,
    and the cotangents dout and ds_final = n."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    r, k, v = (n(B, T, H, K).to(dtype) for _ in range(3))
    x = torch.rand(B, T, H, K, generator=gen, device=device)
    w = (w_range[0] + (w_range[1] - w_range[0]) * x if w_range
         else torch.exp(-torch.exp(-6.0 + 5.2 * x)))
    return r, k, v, w, 0.5 * n(H, K), n(B, H, K, K), n(B, T, H, K), n(B, H, K, K)


def _wkv_close(got, want, name):
    ok = bool(((got - want).abs() <= 2e-4 + 2e-4 * want.abs()).all())
    assert ok and torch.isfinite(got).all(), (name, float((got - want).abs().max()))


def _wkv_grad_close(got, want, name):
    err = float((got - want).abs().max())
    assert err <= 2e-4 * max(1.0, float(want.abs().max())), (name, err)


def _wkv_check(r, k, v, w, u, s0, dout, ds):
    wk.reset_counts()
    out, s_final = wk.wkv_fwd(r, k, v, w, u, s0)
    grads = wk.wkv_bwd(r, k, v, w, u, s0, dout, ds)
    torch.cuda.synchronize()
    assert (wk.wkv_fwd.launches, wk.wkv_bwd.launches) == (1, 1)
    assert (wk.wkv_fwd.ref_calls, wk.wkv_bwd.ref_calls) == (0, 0)
    want_out, want_s = wk.wkv_ref(r, k, v, w, u, s0)
    _wkv_close(out, want_out, "out")
    _wkv_close(s_final, want_s, "s_final")
    want = wk.wkv_bwd_ref(r, k, v, w, u, s0, dout, ds)
    assert (grads[-1] is None) == (s0 is None)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "ds0"), grads, want):
        if x is not None:
            _wkv_grad_close(g, x, name)
    return out, s_final, grads


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "s0-ds_final"])
@pytest.mark.parametrize("shape", [(2, 64, 2, 32), (1, 128, 4, 64), (1, 256, 1, 64),
                                   (2, 96, 2, 32), (1, 4096, 64, 64)],
                         ids=["jax-1", "jax-2", "jax-3", "jax-4", "main-path"])
def test_cuda_wkv_kernels_match_plain(shape, with_state, dtype):
    dev = require_cuda()
    r, k, v, w, u, s0, dout, ds = _wkv_inputs(*shape, dev, dtype=TORCH_DT[dtype])
    if not with_state:
        s0, ds = None, None
    out, s_final, grads = _wkv_check(r, k, v, w, u, s0, dout, ds)
    out2, s2 = wk.wkv_fwd(r, k, v, w, u, s0)
    grads2 = wk.wkv_bwd(r, k, v, w, u, s0, dout, ds)
    assert torch.equal(out2, out) and torch.equal(s2, s_final)
    for g, g2 in zip(grads, grads2):
        assert (g is None and g2 is None) or torch.equal(g, g2)


@pytest.mark.cuda
def test_cuda_wkv_strong_decay_and_state_threading():
    dev = require_cuda()
    _wkv_check(*_wkv_inputs(1, 256, 4, 64, dev, seed=5, w_range=(0.05, 0.3)))
    r, k, v, w, u, *_ = _wkv_inputs(1, 1024, 4, 64, dev, seed=6, dtype=torch.bfloat16)
    out, s_final = wk.wkv_fwd(r, k, v, w, u)
    h = 512
    out_a, s_a = wk.wkv_fwd(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u)
    out_b, s_b = wk.wkv_fwd(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s_a)
    _wkv_close(torch.cat([out_a, out_b], dim=1), out, "out")
    _wkv_close(s_b, s_final, "s_final")


@pytest.mark.cuda
def test_cuda_wkv_autograd_op():
    dev = require_cuda()
    r, k, v, w, u, _, dout, _ = _wkv_inputs(2, 200, 2, 64, dev, seed=7, dtype=torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    wk.reset_counts()
    out, _ = wk.wkv(*leaves)
    out.backward(dout)
    assert (wk.wkv_fwd.launches, wk.wkv_bwd.launches) == (1, 1)
    want = wk.wkv_bwd_ref(r, k, v, w, u, None, dout)
    for name, x, g in zip(("dr", "dk", "dv", "dw", "du"), leaves, want):
        assert x.grad.dtype == x.dtype, name
        # bf16 gradients are the f32 ones rounded once (half an ulp, 2^-8 relative),
        # as JAX's astype VJP rounds them
        bound = 2e-4 * max(1.0, float(g.abs().max())) + 2.0 ** -8 * g.abs()
        assert bool(((x.grad.float() - g).abs() <= bound).all()), name


@pytest.mark.cuda
def test_cuda_wkv_rejects_what_the_kernels_do_not_take():
    dev = require_cuda()
    r, k, v, w, u, s0, _, _ = _wkv_inputs(1, 16, 2, 32, dev)
    with pytest.raises(TypeError, match="one dtype"):
        wk.wkv_fwd(r.half(), k.half(), v.half(), w, u)
    with pytest.raises(TypeError, match="float32"):
        wk.wkv_fwd(r, k, v, w.double(), u)
    r16, k16, v16, w16, u16, *_ = _wkv_inputs(1, 16, 2, 16, dev)
    with pytest.raises(ValueError, match="head sizes"):
        wk.wkv_fwd(r16, k16, v16, w16, u16)
    with pytest.raises(ValueError, match="one device"):
        wk.wkv_fwd(r, k, v, w, u, s0.cpu())


@pytest.mark.cuda
def test_cuda_reduced_rwkv6_post_and_dag_bitwise_equal():
    require_cuda()
    from repro_torch.launch.train import run

    params = []
    for order in ("post", "dag"):
        res = run(["--arch", "rwkv6-7b", "--reduced", "--steps", "2", "--batch", "2",
                   "--seq", "64", "--fuse", "arena", "--policy", "wfbp",
                   "--issue-order", order], quiet=True)
        params.append((res.losses, {n: p.detach().cpu() for n, p in res.model.named_parameters()}))
    assert params[0][0] == params[1][0]
    for n, p in params[0][1].items():
        assert torch.equal(p, params[1][1][n]), n
