"""The CUDA kernels against their plain PyTorch versions, on the card.

comm_pack: bit-identical arena, residuals and unpacked parts over part
dtype {f32, bf16, mixed} x wire {f32, bf16} x EF {off, on}, at odd sizes
and offsets, sources that are not 16-byte aligned, and scale 1/3.

flash_attention: forward, dQ and dK/dV at the full-width main path's
shape (B 4, S 512, 32 query / 4 KV heads, hd 64) in f32 and bf16, at the
tolerances of ``tests/test_kernels.py`` (o 2e-5 f32 / 2e-2 bf16, lse
1e-5, f32 gradients 2e-4; bf16 gradients 1e-2 x max|g|: the bf16
kernels round p (and dS) to bf16 as operands of their second tensor-core
products, the plain versions keep them in f32, both round the result
once); the bf16 forward also at every shape of the JAX package's forward
tests, at RecurrentGemma's attention (MQA, hd 256, window 2048) and with
Sq != Sk; the bf16 backward at RecurrentGemma's attention, hd 32 / 128
with window and softcap, Sq != Sk and a ragged S; forward -> backward
through the kernels' own (o, lse) at both main shapes; f32 inputs keep
the CUDA-core kernels bit for bit; rows that see no key give 0; two runs
give the same bits; and one reduced training step with the flash kernels
gives bitwise the same parameters for the ``post`` and ``dag`` issue
orders.

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
s_final -> s0 matches one run; two runs give the same bits; the chunked
forward also at T below, at and past its 8- and 64-step boundaries (1 to
4096 + 17, K 32 and 64), with exact-zero decays, with chunks that start
with 30 decays of 1e-30 (against the plain version in f64), with decays in
(0.9999, 0.99999) against the plain version in f64 (out at T 529, s_final at T 529 and 4096 + 17), and split at
T/2 + 17 off the chunk grid; the chunked backward alone in every decay
regime of ``tests/test_torch_rwkv6_wkv.py`` (default, strong, 1e-12..1e-6,
near 1 against the plain version in f64, exact zeros, 1e-30 then ~0.99) at T
below, at and past its boundaries, with the forward's chunk states handed
over or computed in the call (the same bits); the autograd op launches
both kernels once and hands the forward's chunk states to the backward;
and reduced RWKV6 trains bitwise equal under ``post`` and ``dag``.

The measured-cost loop: a probe pass between two ``dag`` steps on the card
leaves ``.grad``, the pack launches and ``issue()`` untouched; and the
event-timed comm spans of a ``dag`` step (one per group) end inside the
step, before its own end event.

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


BF16_BWD_CASES = [  # B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap
    (4, 512, 512, 32, 4, 64, True, None, None),  # TinyLlama's layer
    (1, 4096, 4096, 16, 1, 256, True, 2048, None),  # RecurrentGemma's MQA / hd 256 / window
    (2, 256, 256, 4, 2, 32, True, 64, 20.0),  # hd 32 with window and softcap
    (1, 384, 384, 6, 2, 128, True, 256, 30.0),  # hd 128 with window and softcap
    (1, 256, 128, 4, 2, 64, True, 64, None),  # Sq != Sk: rows 191.. see no key
    (1, 300, 300, 4, 2, 64, True, None, None),  # ragged S
    (2, 300, 200, 4, 1, 128, False, 100, None),  # ragged, non-causal, Sq != Sk
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,softcap", BF16_BWD_CASES,
                         ids=["-".join(map(str, c)) for c in BF16_BWD_CASES])
def test_cuda_bf16_backward_kernels_match_plain_and_repeat(B, Sq, Sk, Hq, Hkv, hd, causal,
                                                           window, softcap):
    """The tensor-core dQ and dK/dV kernels (bf16) against their plain
    versions on the same inputs: 1e-2 x max|g| (p and dS are rounded to
    bf16 as operands, the plain versions keep them in f32); a row that sees
    no key gets dq = 0; a second run gives the same bits."""
    from repro_torch.kernels.flash_attention.ref import _mask

    dev = require_cuda()
    q, k, v, do = _qkv(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16, dev, seed=Sq + hd)
    opts = dict(causal=causal, window=window, softcap=softcap)
    o, lse = fa.flash_attention_fwd_ref(q, k, v, **opts)
    delta = fa.attention_delta(o, do)
    fa.reset_counts()
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, **opts)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, **opts)
    torch.cuda.synchronize()
    for fn in (fa.flash_attention_dq, fa.flash_attention_dkv):
        assert (fn.launches, fn.ref_calls) == (1, 0), fn.__name__
    want_dq = fa.flash_attention_dq_ref(q, k, v, do, lse, delta, **opts)
    want_dk, want_dv = fa.flash_attention_dkv_ref(q, k, v, do, lse, delta, **opts)
    for got, want, name in ((dq, want_dq, "dq"), (dk, want_dk, "dk"), (dv, want_dv, "dv")):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert bool(torch.isfinite(got.float()).all()), name
        assert _rel(got, want) <= 1e-2, (name, _rel(got, want))
    blind = ~_mask(Sq, Sk, causal, window, 0, dev).any(dim=1)
    assert torch.equal(dq[:, blind], torch.zeros_like(dq[:, blind]))
    assert torch.equal(fa.flash_attention_dq(q, k, v, do, lse, delta, **opts), dq)
    dk2, dv2 = fa.flash_attention_dkv(q, k, v, do, lse, delta, **opts)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


BF16_FWD_CASES = [  # B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap
    # the JAX package's forward test shapes (tests/test_kernels.py)
    (2, 256, 256, 4, 2, 64, True, None, None),
    (1, 512, 512, 8, 8, 128, True, None, None),
    (2, 256, 256, 4, 1, 64, True, 128, None),
    (1, 256, 256, 2, 2, 64, True, None, 50.0),
    (1, 256, 256, 4, 2, 64, False, None, None),
    (1, 384, 384, 6, 2, 128, True, 256, 30.0),
    (1, 128, 128, 4, 4, 256, True, None, None),
    (4, 512, 512, 32, 4, 64, True, None, None),  # TinyLlama's layer
    (1, 4096, 4096, 16, 1, 256, True, 2048, None),  # RecurrentGemma's MQA / hd 256 / window
    (1, 256, 128, 4, 2, 64, True, 64, None),  # Sq != Sk: rows 191.. see no key
    (2, 300, 200, 4, 1, 128, False, 100, None),  # ragged, non-causal, Sq > Sk
    (2, 200, 300, 4, 2, 32, True, None, 20.0),  # hd 32, Sq < Sk, softcap
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,softcap", BF16_FWD_CASES,
                         ids=["-".join(map(str, c)) for c in BF16_FWD_CASES])
def test_cuda_bf16_forward_kernel_matches_plain_and_repeats(B, Sq, Sk, Hq, Hkv, hd, causal,
                                                            window, softcap):
    """The tensor-core forward (bf16) against its plain version on the same
    inputs: o 2e-2 element by element and 1e-2 in per-row relative L2 over
    the head dim, lse 1e-5 (p is rounded to bf16 as the operand of P V, the
    plain version keeps it in f32); a row that sees no key gets o = 0
    exactly; a second run gives the same bits."""
    from repro_torch.kernels.flash_attention.ref import _mask

    dev = require_cuda()
    q, k, v, _ = _qkv(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16, dev, seed=Sq + hd + 1)
    opts = dict(causal=causal, window=window, softcap=softcap)
    fa.reset_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **opts)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_fwd.ref_calls) == (1, 0)
    want_o, want_lse = fa.flash_attention_fwd_ref(q, k, v, **opts)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape and lse.shape == want_lse.shape
    torch.testing.assert_close(o.float(), want_o.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    blind = ~_mask(Sq, Sk, causal, window, 0, dev).any(dim=1)
    seen = ~blind[None, :, None]
    row = (o.float() - want_o.float()).norm(dim=-1) / want_o.float().norm(dim=-1)
    assert float(row[seen.expand_as(row)].max()) <= 1e-2
    assert torch.equal(o[:, blind], torch.zeros_like(o[:, blind]))
    o2, lse2 = fa.flash_attention_fwd(q, k, v, return_lse=True, **opts)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.cuda
def test_cuda_f32_forward_keeps_the_cuda_core_kernel():
    """f32 inputs go to flash_fwd_kernel of flash_attention.cu: the
    wrapper's results are that kernel's bits."""
    from repro_torch.kernels.flash_attention import ops

    dev = require_cuda()
    B, S, Hq, Hkv, hd = MAIN_SHAPE
    q, k, v, _ = _qkv(B, S, S, Hq, Hkv, hd, torch.float32, dev, seed=4)
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    _, tail = ops._cuda_args(q, k, v, causal=True, window=None, softcap=None)
    want_o, want_lse = torch.empty_like(q), torch.empty_like(lse)
    assert ops._library().flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), want_o.data_ptr(),
                                    want_lse.data_ptr(), *tail) == 0
    torch.cuda.synchronize()
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window", [(4, 512, 32, 4, 64, None),
                                                   (1, 4096, 16, 1, 256, 2048)],
                         ids=["tinyllama", "recurrentgemma"])
def test_cuda_fwd_to_bwd_through_the_kernels_own_o_and_lse(B, S, Hq, Hkv, hd, window):
    """The training op on the card (bf16): the backward kernels read the
    forward kernel's own (o, lse).  dq, dk, dv lie within 1e-2 x max|g| of
    the plain backward fed the plain forward's (o, lse)."""
    dev = require_cuda()
    q, k, v, do = _qkv(B, S, S, Hq, Hkv, hd, torch.bfloat16, dev, seed=5)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    fa.reset_counts()
    fa.flash_attention_train(qg, kg, vg, window=window).backward(do)
    torch.cuda.synchronize()
    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv):
        assert (fn.launches, fn.ref_calls) == (1, 0), fn.__name__
    want_o, want_lse = fa.flash_attention_fwd_ref(q, k, v, window=window)
    want = fa.flash_attention_bwd_ref(q, k, v, want_o, want_lse, do, window=window)
    for got, w, name in zip((qg.grad, kg.grad, vg.grad), want, ("dq", "dk", "dv")):
        assert bool(torch.isfinite(got.float()).all()), name
        assert _rel(got, w) <= 1e-2, (name, _rel(got, w))


@pytest.mark.cuda
def test_cuda_f32_backward_keeps_the_cuda_core_kernels():
    """f32 inputs go to flash_dq_kernel / flash_dkv_kernel of
    flash_attention.cu: the wrappers' results are those kernels' bits."""
    from repro_torch.kernels.flash_attention import ops

    dev = require_cuda()
    B, S, Hq, Hkv, hd = MAIN_SHAPE
    q, k, v, do = _qkv(B, S, S, Hq, Hkv, hd, torch.float32, dev, seed=3)
    o, lse = fa.flash_attention_fwd_ref(q, k, v)
    delta = fa.attention_delta(o, do)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta)
    _, tail = ops._cuda_args(q, k, v, do, causal=True, window=None, softcap=None)
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    want_dq, want_dk, want_dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    assert ops._library().flash_dq(*ptrs, want_dq.data_ptr(), *tail) == 0
    assert ops._library().flash_dkv(*ptrs, want_dk.data_ptr(), want_dv.data_ptr(), *tail) == 0
    torch.cuda.synchronize()
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert torch.equal(got, want)


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


def _wkv_fwd_check(r, k, v, w, u, s0=None, exact=False):
    """wkv_fwd launches (once) and holds out / s_final at the gate against
    wkv_ref (in f64 on f64 copies of the inputs if ``exact``); a second
    call gives the same bits."""
    wk.reset_counts()
    out, s_final = wk.wkv_fwd(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert (wk.wkv_fwd.launches, wk.wkv_fwd.ref_calls) == (1, 0)
    want_out, want_s = wk.wkv_ref(*(t.double() if exact and t is not None else t
                                    for t in (r, k, v, w, u, s0)))
    _wkv_close(out.double() if exact else out, want_out, "out")
    _wkv_close(s_final.double() if exact else s_final, want_s, "s_final")
    out2, s2 = wk.wkv_fwd(r, k, v, w, u, s0)
    assert torch.equal(out2, out) and torch.equal(s2, s_final)
    return out, s_final


@pytest.mark.cuda
@pytest.mark.parametrize("K", [32, 64])
@pytest.mark.parametrize("T", [1, 8, 9, 15, 16, 63, 64, 65, 4096 + 17])
def test_cuda_wkv_fwd_chunk_boundaries(T, K):
    """The forward's 64-step chunks and 8-step sub-chunks: T below, at and
    past each boundary, r/k/v in f32 and bf16, with and without s0."""
    dev = require_cuda()
    for dtype, with_s0 in ((torch.float32, True), (torch.bfloat16, False)):
        r, k, v, w, u, s0, _, _ = _wkv_inputs(1, T, 4, K, dev, seed=T, dtype=dtype)
        _wkv_fwd_check(r, k, v, w, u, s0 if with_s0 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["zeros", "mixed"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_wkv_fwd_zero_and_mixed_decays(mode, dtype):
    """w with exact zeros (the log floor), and chunks whose first 30 steps
    decay by 1e-30 and the rest by ~0.99 (exponents never cancel).  The
    second is held against wkv_ref in f64, as the near-1 decays are: the
    f32 loop's own rounding over the ~0.99 runs is of the kernel's size
    (``chip_smoke.py`` phase 1d prints both readings)."""
    dev = require_cuda()
    B, T, H, K = 1, 1024, 4, 64
    r, k, v, w, u, s0, _, _ = _wkv_inputs(B, T, H, K, dev, seed=8, dtype=TORCH_DT[dtype])
    x = torch.rand(w.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(9))
    if mode == "zeros":
        w = torch.where(x < 0.3, torch.zeros_like(w), w)
    else:
        w = 0.985 + 0.01 * x
        w[:, torch.arange(T, device=dev) % 64 < 30] = 1e-30
    _wkv_fwd_check(r, k, v, w, u, s0, exact=mode == "mixed")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T,state_only", [(512 + 17, False), (4096 + 17, True)],
                         ids=["T529", "T4113-s_final"])
def test_cuda_wkv_fwd_near_one_decays(T, state_only, dtype):
    """w in (0.9999, 0.99999): each step's log decay is ~1e-5, and an error
    in it adds up over the whole walk.  The f32 sequential loop's own
    rounding adds up too (past the gate from a few hundred steps on, see
    ``tests/test_torch_rwkv6_wkv.py``), so the kernel is held at the same
    gate against wkv_ref in f64: out and s_final at T 529, s_final, which
    carries the whole walk's decay, at T 4113."""
    dev = require_cuda()
    r, k, v, w, u, s0, _, _ = _wkv_inputs(1, T, 8, 64, dev, seed=11, dtype=TORCH_DT[dtype],
                                          w_range=(0.9999, 0.99999))
    wk.reset_counts()
    out, s_final = wk.wkv_fwd(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert (wk.wkv_fwd.launches, wk.wkv_fwd.ref_calls) == (1, 0)
    want_out, want_s = wk.wkv_ref(*(t.double() for t in (r, k, v, w, u, s0)))
    if not state_only:
        _wkv_close(out.double(), want_out, "out")
    _wkv_close(s_final.double(), want_s, "s_final")


@pytest.mark.cuda
def test_cuda_wkv_fwd_split_off_the_chunk_grid():
    """A run split at T/2 + 17, off the 64-step grid, and threaded through
    s_final -> s0 matches one run and the plain version."""
    dev = require_cuda()
    B, T, H, K = 1, 4096, 8, 64
    r, k, v, w, u, *_ = _wkv_inputs(B, T, H, K, dev, seed=10, dtype=torch.bfloat16)
    out, s_final = _wkv_fwd_check(r, k, v, w, u)
    h = T // 2 + 17
    out_a, s_a = wk.wkv_fwd(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u)
    out_b, s_b = wk.wkv_fwd(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s_a)
    _wkv_close(torch.cat([out_a, out_b], dim=1), out, "out")
    _wkv_close(s_b, s_final, "s_final")


def _wkv_decay(mode, shape, device, seed):
    """w on the card in the regimes of tests/test_torch_rwkv6_wkv.py's
    ``_decay``: default ~(0.63, 0.999), strong (0.05, 0.3), extreme
    10^U(-12, -6), near-1 (0.9999, 0.99999), the default with ~30% exact
    zeros, and 1e-30 in steps 0-29 of every 64 with ~0.99 after."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    if mode == "strong":
        w = 0.05 + 0.25 * x
    elif mode == "extreme":
        w = 10.0 ** (-12.0 + 6.0 * x)
    elif mode == "near1":
        w = 0.9999 + 0.00009 * x
    elif mode == "mixed":
        w = 0.985 + 0.01 * x
        w[:, torch.arange(shape[1], device=device) % 64 < 30] = 1e-30
    else:
        w = torch.exp(-torch.exp(-6.0 + 5.2 * x))
        if mode == "zeros":
            w = torch.where(torch.rand(shape, generator=gen, device=device) < 0.3, 0.0, w)
    return w.float()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 8, 9, 63, 64, 65, 512 + 17])
@pytest.mark.parametrize("mode", ["default", "strong", "extreme", "near1", "zeros", "mixed"])
def test_cuda_wkv_bwd_decays_and_chunk_boundaries(mode, T):
    """The chunked backward in every decay regime, at T below, at and past
    its 8- and 64-step boundaries, bf16 r/k/v with s0 and ds_final: every
    gradient within 2e-4 x max(1, max|g|) of wkv_bwd_ref (in f64 on f64
    copies near 1, where the f32 loop's own rounding adds up), finite; one
    launch and no plain call a call; the forward's chunk states handed over
    give the same bits as those the call computes; a second call too."""
    dev = require_cuda()
    B, H, K = 1, 4, 64
    r, k, v, _, u, s0, dout, ds = _wkv_inputs(B, T, H, K, dev, seed=T, dtype=torch.bfloat16)
    w = _wkv_decay(mode, (B, T, H, K), dev, seed=T + 1)
    args = (r, k, v, w, u, s0, dout, ds)
    wk.reset_counts()
    grads = wk.wkv_bwd(*args)
    torch.cuda.synchronize()
    assert (wk.wkv_bwd.launches, wk.wkv_bwd.ref_calls) == (1, 0)
    want = wk.wkv_bwd_ref(*(x.double() for x in args) if mode == "near1" else args)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "ds0"), grads, want):
        assert torch.isfinite(g).all(), name
        _wkv_grad_close(g.double(), x.double(), name)
    _, _, states = wk.ops._wkv_fwd(r, k, v, w, u, s0)
    for again in (wk.wkv_bwd(*args, chunk_states=states), wk.wkv_bwd(*args)):
        assert all(torch.equal(g, g2) for g, g2 in zip(grads, again))


@pytest.mark.cuda
def test_cuda_wkv_autograd_op():
    from torch.profiler import ProfilerActivity, profile

    dev = require_cuda()
    r, k, v, w, u, _, dout, _ = _wkv_inputs(2, 200, 2, 64, dev, seed=7, dtype=torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    states = wk.ops._wkv_fwd(r, k, v, w, u, None)[2]
    wk.reset_counts()
    out, _ = wk.wkv(*leaves)
    # the forward keeps its own chunk states for the backward ...
    assert torch.equal(out.grad_fn.saved_tensors[-1], states)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out.backward(dout)
        torch.cuda.synchronize()
    assert (wk.wkv_fwd.launches, wk.wkv_bwd.launches) == (1, 1)
    # ... so the backward runs no forward walk of its own
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("wkv_bwd_state_kernel" in x for x in names), names
    assert not any("wkv_fwd_state_kernel" in x for x in names), names
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


def _nccl_world1():
    """A one-rank NCCL group on a FileStore unless a group exists; returns
    a callable that tears down only what it made."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    if dist.is_initialized():
        return lambda: None
    tmp = tempfile.mkdtemp(prefix="repro_torch_cuda_pg_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)

    def down():
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    return down


def _reduced_dag_step(recorder=None):
    from repro_torch.configs import get_reduced
    from repro_torch.core.comm_model import AllReduceModel
    from repro_torch.core.sync import SyncConfig
    from repro_torch.core.trainer import MGWFBPEngine, batch_to_device
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.models import Transformer, param_shapes
    from repro_torch.optim import make_optimizer

    cfg = get_reduced("tinyllama-1.1b", param_dtype=torch.float32)
    eng = MGWFBPEngine.build(cfg, param_shapes(cfg), ar_model=AllReduceModel(a=5e-5, b=1e-9),
                             tokens_per_device=128, policy="wfbp",
                             sync_config=SyncConfig(fuse="arena"))
    model = Transformer(cfg, device="cuda", seed=0)
    step = eng.make_train_step(model, make_optimizer("adamw"), issue="dag", recorder=recorder)
    batch = batch_to_device(
        make_stream(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2)).batch_at(0),
        torch.device("cuda"))
    return cfg, eng, model, step, batch


@pytest.mark.cuda
def test_cuda_probes_leave_the_dag_step_alone():
    """A probe pass on the card between two ``dag`` steps writes no
    ``.grad``, launches no pack and calls ``issue()`` for nothing."""
    require_cuda()
    from repro_torch.fabric.ops import issue
    from repro_torch.runtime import probe_unit_times

    down = _nccl_world1()
    try:
        cfg, eng, model, step, batch = _reduced_dag_step()
        try:
            step(batch)
            torch.cuda.synchronize()
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            calls, packs = issue.calls, pack_arena.launches
            prof = probe_unit_times(cfg, model, batch, eng.plan.layout)
            torch.cuda.synchronize()
            assert issue.calls == calls and pack_arena.launches == packs
            for n, p in model.named_parameters():
                assert torch.equal(p.grad, grads[n]), n
            assert all(np.isfinite(s) and s > 0 for s in prof.unit_seconds.values())
            step(batch)
            assert issue.calls == calls + eng.sync.n_groups
        finally:
            step.close()
    finally:
        down()


@pytest.mark.cuda
def test_cuda_comm_spans_end_before_the_step_ends():
    """Event-timed spans of a ``dag`` step: one comm span per group, each
    ending (on the recorder's stream that waits for the collective) before
    the step's own end event, with backward spans per unit."""
    require_cuda()
    from repro_torch.core.profiler import GROUP_SPAN_RE, TraceRecorder, overlap_report

    down = _nccl_world1()
    try:
        rec = TraceRecorder(cuda=True)
        cfg, eng, model, step, batch = _reduced_dag_step(rec)
        try:
            step(batch)  # warm-up
            torch.cuda.synchronize()
            rec.clear()
            rec.span_begin("step")
            step(batch)
            rec.span_end("step")
            torch.cuda.synchronize()
        finally:
            step.close()
        spans = rec.spans()
        (whole,) = [s for s in spans if s.name == "step"]
        comm = [s for s in spans if GROUP_SPAN_RE.match(s.name)]
        assert len(comm) == eng.sync.n_groups
        for s in comm:
            assert s.dur_us >= 0 and whole.start_us <= s.start_us and s.end_us <= whole.end_us
        rep = overlap_report(spans)
        assert rep["n_bwd_spans"] == 2 + cfg.n_stages and rep["n_comm_spans"] == len(comm)
    finally:
        down()
