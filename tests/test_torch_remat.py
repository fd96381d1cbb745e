"""``remat='dots'`` (selective activation checkpointing) against the JAX
model's ``dots_with_no_batch_dims_saveable``.

Every check runs ``get_reduced`` configs in fp32 on the CPU from the same
weights and batch (``tests/_torch_arch.py``'s helpers and tolerances: loss
rtol 1e-5, every gradient leaf max-abs <= 1e-4 x that leaf's max |g|):

* the loss and gradients under ``'dots'`` match JAX's ``value_and_grad`` of
  ``loss_fn`` at ``remat='dots'``, and equal the port's ``'full'`` and
  ``'none'`` bit for bit;
* one stage saves what JAX's ``saved_residuals`` of ``apply_stage`` lists
  (arguments and constants left out), as a multiset of element counts.  JAX
  remats a whole stage, the port each sublayer: a region's input is kept
  for its recompute, so a stage of n sublayers keeps n - 1 (B, S, d) inputs
  beyond the stage's own.  Under ``'dots'`` they take the place of the
  JAX stage's down projections that feed the next sublayer; where a post-norm
  reads the down projection as well (Gemma2) they are extra, and under
  ``'full'`` they are all extra.  The port also saves every down projection
  that JAX drops because only the residual add reads it (ROADMAP C);
* no forward 2D product runs again in backward under ``'dots'``, and every
  batched one does;
* at the JAX package's own init of reduced RWKV6, where the two packages'
  f32 gradients of stage 0 differ by more than the 1e-4 gate, both packages
  run with every float32 they name made float64 agree to 1e-10: the gap is
  f32 rounding on both sides, not a difference of the function (ROADMAP C).
"""

from __future__ import annotations

import collections
import functools
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from jax._src.ad_checkpoint import saved_residuals

import _torch_arch as A
import test_torch_rwkv6
from _env import REPO_ROOT, SUBPROC_ENV
from repro.models import loss_fn as jax_loss_fn
from repro.models.transformer import apply_stage
from repro_torch.configs import ARCH_NAMES
from repro_torch.core.trainer import batch_to_device, unread_params
from repro_torch.models import from_jax_params
from repro_torch.models import transformer as T

from repro_torch.runtime.timeline import make_unit_probes

OP_COUNT_ARCHS = ("tinyllama-1.1b", "mixtral-8x7b", "recurrentgemma-9b", "rwkv6-7b")
# (B, S, d) tensors a port stage keeps beyond JAX's saved set under 'dots'
# (ROADMAP C): each MLP down projection without a post-norm, which only the
# residual add reads (one for the other archs), and Gemma2's second region
# input, beside the down projection its post-norm reads
DOTS_EXTRA = {"gemma2-2b": 1, "recurrentgemma-9b": 3, "mixtral-8x7b": 0, "dbrx-132b": 0,
              "rwkv6-7b": 0}
PRODUCTS = ("aten.mm.default", "aten.addmm.default")
BATCHED = ("aten.bmm.default",)
CPU = torch.device("cpu")


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _count(counts, names) -> int:
    return sum(counts[n] for n in names)


def _weights(jcfg):
    """The reference's init; RWKV6's constant-at-init leaves drawn as
    ``tests/test_torch_rwkv6.py`` draws them (at its init the f32 rounding
    of stage 0's gradients, on either side, passes the 1e-4 gate:
    ``test_rwkv6_init_gap_is_f32_rounding``)."""
    if jcfg.name.startswith("rwkv6"):
        return test_torch_rwkv6._weights(jcfg)
    return A.weights(jcfg)


@functools.cache
def _jax_dots(arch):
    jcfg, tcfg = A.cfgs(arch, remat="dots")
    params = _weights(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in A.batch(tcfg).items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, jcfg), has_aux=True)(jax.tree.map(jnp.asarray, params))
    return params, float(jloss), from_jax_params(jax.tree.map(np.asarray, jgrads), tcfg)


def _port_run(arch, remat, params):
    """(loss, {name: grad}, forward op counts, backward op counts) of the
    port at ``remat`` from ``params``."""
    _, tcfg = A.cfgs(arch, remat=remat)
    model = A.port_model(tcfg, params)
    batch = batch_to_device(A.batch(tcfg), CPU)
    with _OpCount() as fwd:
        loss = model.loss(batch)
    with _OpCount() as bwd:
        loss.backward()
    unread = unread_params(tcfg)
    grads = {n: p.grad for n, p in model.named_parameters() if n not in unread}
    return loss.detach(), grads, fwd.counts, bwd.counts


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_dots_matches_jax_and_equals_full_and_none(arch):
    params, jloss, want = _jax_dots(arch)
    loss, got, _, _ = _port_run(arch, "dots", params)
    np.testing.assert_allclose(float(loss), jloss, rtol=A.LOSS_RTOL)
    for n, g in got.items():
        scale = float(np.max(np.abs(want[n])))
        err = float(np.max(np.abs(g.numpy() - want[n])))
        assert err <= A.GRAD_REL * scale, (n, err, scale)
    for remat in ("full", "none"):
        other_loss, other, _, _ = _port_run(arch, remat, params)
        assert torch.equal(other_loss, loss), remat
        assert other.keys() == got.keys()
        for n in got:
            assert torch.equal(other[n], got[n]), (remat, n)


def _jax_stage_saved(arch, remat) -> list[int]:
    """Element counts of JAX's residuals for one stage at the test batch,
    arguments and constants left out."""
    jcfg, _ = A.cfgs(arch, remat=remat)
    stage = jax.tree.map(lambda a: jnp.asarray(a[0]), _weights(jcfg)["stages"])
    B, S = A.B, A.S
    x = jnp.ones((B, S, jcfg.d_model), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    if jcfg.attention is not None and jcfg.attention.rope == "mrope":
        pos = jnp.broadcast_to(pos, (3, B, S))

    def fn(sp, xx):
        y, _, aux = apply_stage(sp, xx, jcfg, jcfg.pattern, positions=pos)
        return y, aux

    wrapped = (jax.checkpoint(fn) if remat == "full" else
               jax.checkpoint(fn, policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable))
    return sorted(int(np.prod(aval.shape)) for aval, why in saved_residuals(wrapped, stage, x)
                  if not why.startswith(("from the argument", "from a constant")))


def _port_stage_saved(arch, remat, monkeypatch) -> list[int]:
    """Element counts of what one port stage keeps beyond its arguments:
    each ``dots_policy`` product the stage's regions hold after the forward,
    and each region's input but the first."""
    _, tcfg = A.cfgs(arch, remat=remat)
    model = A.port_model(tcfg, _weights(A.cfgs(arch)[0]))
    held, contexts = [], T.dots_contexts

    def recording():
        fwd, rec = contexts()
        held.append(fwd.storage)
        return fwd, rec

    monkeypatch.setattr(T, "dots_contexts", recording)
    B, S = A.B, A.S
    x = torch.ones((B, S, tcfg.d_model), requires_grad=True)
    pos = torch.arange(S)[None, :].expand(B, S)
    if tcfg.attention is not None and tcfg.attention.rope == "mrope":
        pos = pos[None].expand(3, B, S)
    y = x
    subs = list(model.stages[0].values())
    for sub in subs:
        y, _ = T.run_sublayer(sub, y, pos, remat)
    kept = [v.val.numel() for storage in held for entries in storage.values()
            for v in (entries.values() if isinstance(entries, dict) else entries)
            if hasattr(v, "val")]
    return sorted(kept + [B * S * tcfg.d_model] * (len(subs) - 1))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_dots_stage_saves_what_jax_saves(arch, monkeypatch):
    _, tcfg = A.cfgs(arch)
    jax_saved = _jax_stage_saved(arch, "dots")
    extra = [A.B * A.S * tcfg.d_model] * DOTS_EXTRA.get(arch, 1)
    assert _port_stage_saved(arch, "dots", monkeypatch) == sorted(jax_saved + extra)


@pytest.mark.parametrize("arch", OP_COUNT_ARCHS)
def test_full_stage_keeps_only_region_inputs(arch, monkeypatch):
    _, tcfg = A.cfgs(arch)
    assert _jax_stage_saved(arch, "full") == []
    n_sub = len(tcfg.pattern)
    assert _port_stage_saved(arch, "full", monkeypatch) == [A.B * A.S * tcfg.d_model] * (n_sub - 1)


@pytest.mark.parametrize("arch", OP_COUNT_ARCHS)
def test_dots_reruns_batched_products_only(arch):
    params = _weights(A.cfgs(arch)[0])
    runs = {remat: _port_run(arch, remat, params) for remat in ("full", "dots", "none")}
    fwd = {remat: r[2] for remat, r in runs.items()}
    bwd = {remat: r[3] for remat, r in runs.items()}
    for names in (PRODUCTS, BATCHED):
        assert _count(fwd["dots"], names) == _count(fwd["none"], names) == _count(fwd["full"], names)
    # backward runs the 2D products of 'none' (the gradients' own) and no forward one again
    assert _count(bwd["dots"], PRODUCTS) == _count(bwd["none"], PRODUCTS)
    assert _count(bwd["full"], PRODUCTS) > _count(bwd["dots"], PRODUCTS)
    # and every batched forward product again, as under 'full'
    assert _count(bwd["dots"], BATCHED) == _count(bwd["full"], BATCHED)
    assert _count(bwd["dots"], BATCHED) > _count(bwd["none"], BATCHED)


def test_unit_probes_run_the_policy():
    """The measured-cost probes price what the step runs: under ``'dots'``
    the stage and tail probes give ``'full'``'s gradients bit for bit with
    fewer 2D products in them."""
    arch = "recurrentgemma-9b"  # a stage of three sublayers and a tail
    params = _weights(A.cfgs(arch)[0])
    out = {}
    for remat in ("full", "dots"):
        _, tcfg = A.cfgs(arch, remat=remat)
        model = A.port_model(tcfg, params)
        probes = make_unit_probes(tcfg, model, batch_to_device(A.batch(tcfg), CPU))
        for unit in ("stage", "tail"):
            fn, args = probes[unit]
            with _OpCount() as ops:
                grads = fn(*args)
            out[remat, unit] = (grads, _count(ops.counts, PRODUCTS))
    for unit in ("stage", "tail"):
        (full, n_full), (dots, n_dots) = out["full", unit], out["dots", unit]
        assert all(torch.equal(a, b) for a, b in zip(full, dots, strict=True)), unit
        assert n_dots < n_full, unit


def test_policy_marks_2d_products_only():
    ctx = None
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert T.dots_policy(ctx, mm) == T.CheckpointPolicy.MUST_SAVE
    assert T.dots_policy(ctx, torch.ops.aten.addmm.default) == T.CheckpointPolicy.MUST_SAVE
    assert T.dots_policy(ctx, bmm) == T.CheckpointPolicy.PREFER_RECOMPUTE
    assert T.dots_policy(ctx, torch.ops.aten.empty.memory_format) == \
        T.CheckpointPolicy.PREFER_RECOMPUTE


def test_unknown_remat_raises():
    _, tcfg = A.cfgs("tinyllama-1.1b", remat="offload")
    with pytest.raises(NotImplementedError, match="remat"):
        A.port_model(tcfg, _weights(A.cfgs("tinyllama-1.1b")[0]))
    _, tcfg = A.cfgs("tinyllama-1.1b")
    sub = A.port_model(tcfg, _weights(A.cfgs("tinyllama-1.1b")[0])).stages[0]["attn_0"]
    x = torch.ones((1, 8, tcfg.d_model))
    with pytest.raises(ValueError, match="remat"):
        T.run_sublayer(sub, x, torch.arange(8)[None], "dot")


F64_WITNESS = textwrap.dedent("""
    import json, sys, types
    sys.path.insert(0, %(tests)r)
    import jax
    jax.config.update("jax_enable_x64", True)
    import dataclasses
    import numpy as np
    import torch
    import jax.numpy as jnp
    import _torch_arch as A
    from repro.models import loss_fn
    torch.set_num_threads(1)  # one summation order: the f32 error depends on it
    from repro_torch.core.trainer import batch_to_device
    from repro_torch.models import Transformer, from_jax_params, load_arrays

    jcfg, tcfg = A.cfgs("rwkv6-7b")
    params = A.weights(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in A.batch(tcfg).items()}

    def jax_grads(cfg, dtype):
        p = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        g = jax.grad(lambda q: loss_fn(q, jbatch, cfg)[0])(p)
        return from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float64), g), tcfg)

    def port_grads(dtype):
        cfg = dataclasses.replace(tcfg, param_dtype=dtype)
        model = Transformer(cfg, device="cpu", seed=None).to(dtype)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        load_arrays(model, from_jax_params(jax.tree.map(lambda a: a.astype(np_dtype), params), cfg))
        model.loss(batch_to_device(A.batch(cfg), torch.device("cpu"))).backward()
        return {n: p.grad.double().numpy() for n, p in model.named_parameters()
                if p.grad is not None}

    j32, p32 = jax_grads(jcfg, jnp.float32), port_grads(torch.float32)
    # every float32 that the two packages' modules name becomes float64
    class Promoted(types.ModuleType):
        def __init__(self, mod):
            super().__init__(mod.__name__)
            self.mod = mod
        def __getattr__(self, name):
            return getattr(self.mod, "float64" if name == "float32" else name)
    wrapped = {id(m): Promoted(m) for m in (torch, jnp, np)}
    for name, mod in list(sys.modules.items()):
        if mod is not None and name.startswith(("repro.", "repro_torch.")):
            for attr, val in list(vars(mod).items()):
                if id(val) in wrapped and not (val is np and name.startswith("repro_torch.")):
                    setattr(mod, attr, wrapped[id(val)])
    torch.Tensor.float = torch.Tensor.double
    j64 = jax_grads(dataclasses.replace(jcfg, param_dtype=jnp.float64), jnp.float64)
    p64 = port_grads(torch.float64)

    def rel(a, b):
        return {n: float(np.max(np.abs(a[n] - b[n])) / np.max(np.abs(j64[n]))) for n in p64}
    print(json.dumps({"p64_j64": rel(p64, j64), "j32_j64": rel(j32, j64),
                      "p32_p64": rel(p32, p64), "p32_j32": rel(p32, j32)}))
""" % {"tests": str(REPO_ROOT / "tests")})


def test_rwkv6_init_gap_is_f32_rounding():
    """At the JAX package's own init of reduced RWKV6 (``u`` and ``mu_*``
    zero, ``decay_base`` -1) the two packages' f32 gradients of stage 0 sit
    up to 5.3e-4 x max|g| apart, above the 1e-4 gate.  Run with every
    float32 both packages name made float64, they agree to 1e-10 on every
    leaf: the function is the same.  Each side's f32 is off that f64 in its
    own direction (JAX 1.8e-4, the port 3.6e-4 on ``embed``): the gap is f32
    rounding on both sides.  The port's f32 error depends on the order of
    its CPU reductions (one thread here; up to 1.1e-2 seen with six), so
    the f32 bounds hold at one thread and the f64 agreement at any."""
    out = subprocess.run([sys.executable, "-c", F64_WITNESS], capture_output=True, text=True,
                         timeout=600, env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"), cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert max(rec["p64_j64"].values()) <= 1e-10, rec["p64_j64"]
    assert A.GRAD_REL < rec["p32_j32"]["embed"] < 1e-3, rec["p32_j32"]
    for side in ("j32_j64", "p32_p64"):
        assert max(rec[side].values()) < 1e-3, (side, rec[side])
    # the gap stays within the sum of the two packages' own f32 errors
    assert all(rec["p32_j32"][n] <= rec["j32_j64"][n] + rec["p32_p64"][n] for n in rec["p32_j32"])
