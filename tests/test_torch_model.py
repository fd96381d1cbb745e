"""Model parity: the port's reduced tinyllama against the JAX package's,
in fp32 on the CPU, from the same weights (``from_jax_params`` of the
reference's ``init_params``) and the same batch.

Tolerances.  Both sides compute in f32 but in different kernels (XLA vs
ATen matmuls, einsums, softmax, cos/sin), so sums are taken in other
orders: the loss must agree to rtol 1e-5 and every gradient leaf to a
max-abs error of 1e-4 x that leaf's max |g| — a few hundred f32 ulps of
the leaf's scale, far below any algorithmic difference (a wrong mask,
scale or RoPE half would be off by O(1) of the scale).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_env import bits
from repro.configs import get_reduced as jax_get_reduced
from repro.data import DataConfig as JaxDataConfig, make_stream as jax_make_stream
from repro.models import loss_fn as jax_loss_fn
from repro.models.transformer import init_params
from repro.optim.optimizers import adamw_init as jax_adamw_init, adamw_update as jax_adamw_update
from repro.optim.optimizers import sgd_init as jax_sgd_init, sgd_update as jax_sgd_update
from repro_torch.configs import get_reduced
from repro_torch.core.trainer import batch_to_device
from repro_torch.data import DataConfig, make_stream
from repro_torch.models import Transformer, from_jax_params, load_arrays, to_jax_params
from repro_torch.optim import adamw_init, adamw_update, sgd_init, sgd_update

ARCH = "tinyllama-1.1b"
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def _cfgs(dtype="f32", attn_impl="flash", **kw):
    """(reference config, port config); ``attn_impl`` is the port's (the
    reference model always runs its jnp attention)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jax_get_reduced(ARCH, param_dtype=jdt, **kw),
            get_reduced(ARCH, param_dtype=tdt, attn_impl=attn_impl, **kw))


def _weights(jcfg, seed=0):
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed), jcfg))


def _batch(B=2, S=64, step=0):
    return make_stream(DataConfig(vocab=256, seq_len=S, global_batch=B)).batch_at(step)


def _port_model(tcfg, np_params):
    model = Transformer(tcfg, device="cpu", seed=None)
    load_arrays(model, from_jax_params(np_params, tcfg))
    return model


def test_data_pipeline_matches_reference():
    for rank, count in ((0, 1), (1, 2)):
        t = make_stream(DataConfig(vocab=256, seq_len=33, global_batch=4), rank, count)
        j = jax_make_stream(JaxDataConfig(vocab=256, seq_len=33, global_batch=4), rank, count)
        for step in (0, 1, 7):
            tb, jb = t.batch_at(step), j.batch_at(step)
            np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
            np.testing.assert_array_equal(tb["targets"], jb["targets"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weight_bridge_round_trip_is_exact(dtype):
    jcfg, tcfg = _cfgs(dtype)
    ref = _weights(jcfg)
    back = to_jax_params(_port_model(tcfg, ref))
    jl, jt = jax.tree_util.tree_flatten_with_path(ref)
    bl, bt = jax.tree_util.tree_flatten_with_path(back)
    assert jt == bt
    for (p, a), (_, b) in zip(jl, bl):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("attn_impl", ["flash", "plain"])
def test_loss_and_every_gradient_match_reference(attn_impl):
    """Both of the port's attention paths (the flash op, here through its
    plain versions on the CPU, and the plain einsum/softmax path) against
    the reference model, which runs its jnp attention."""
    jcfg, tcfg = _cfgs("f32", attn_impl=attn_impl)
    params = _weights(jcfg)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, jcfg), has_aux=True
    )(jax.tree.map(jnp.asarray, params))

    model = _port_model(tcfg, params)
    loss = model.loss(batch_to_device(batch, torch.device("cpu")))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)

    want = from_jax_params(jax.tree.map(np.asarray, jgrads), tcfg)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        scale = float(np.max(np.abs(want[n])))
        err = float(np.max(np.abs(got[n] - want[n])))
        assert err <= GRAD_REL * scale, (n, err, scale)


def test_remat_does_not_change_the_math():
    """torch.utils.checkpoint per layer recomputes the same ops: the
    gradients are bitwise those of the un-checkpointed model."""
    jcfg, tcfg = _cfgs("f32")
    params = _weights(jcfg)
    batch = batch_to_device(_batch(), torch.device("cpu"))
    grads = []
    for remat in ("full", "none"):
        model = _port_model(get_reduced(ARCH, param_dtype=torch.float32, remat=remat), params)
        model.loss(batch).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


@pytest.mark.parametrize("opt", ["adamw", "sgd_momentum"])
def test_one_optimizer_step_matches_reference(opt):
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (13,)}
    p_np = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g_np = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jp, jg = jax.tree.map(jnp.asarray, p_np), jax.tree.map(jnp.asarray, g_np)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    tg = {k: torch.from_numpy(v.copy()) for k, v in g_np.items()}
    if opt == "adamw":
        js = jax_adamw_init(jp)
        ts = adamw_init(tp)
        for _ in range(2):
            jp, js = jax_adamw_update(jg, js, jp, 1e-2)
            adamw_update(tg, ts, tp, 1e-2)
    else:
        js = jax_sgd_init(jp, 0.9)
        ts = sgd_init(tp, 0.9)
        for _ in range(2):
            jp, js = jax_sgd_update(jg, js, jp, 1e-2, 0.9)
            sgd_update(tg, ts, tp, 1e-2, 0.9)
    for k in shapes:
        # same f32 expressions; XLA may fuse them into FMAs, so allow 2 ulp
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=3e-7, atol=1e-7)
