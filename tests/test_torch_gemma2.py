"""Gemma2-2B (alternating ``attn_local`` / ``attn_global`` layers, post-block
norms, gemma RMSNorm, GeGLU, the attention softcap of 50 and the final-logit
softcap of 30, tied embeddings) in the port against the JAX package, on
``get_reduced('gemma2-2b')`` in fp32 on the CPU, from the same weights.  The
checks and their tolerances are ``tests/_torch_arch.py``'s.  The sequence is
128 tokens, so the local layers' 64-key window masks keys; the chunked-CE
case runs the logit softcap inside the checkpointed 512-token chunks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_arch as A
from repro.models import loss_fn as jax_loss_fn
from repro_torch.configs import get_config
from repro_torch.core.trainer import batch_to_device
from repro_torch.models import Transformer, from_jax_params, param_shapes
from repro_torch.models.layers import gqa_attention
from repro_torch.models.transformer import window_for

ARCH = "gemma2-2b"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weight_bridge_round_trip_is_exact(dtype):
    """The post-norms round trip, and the absent head (tied embeddings)."""
    ref = A.check_bridge_round_trip(ARCH, dtype)
    assert "head" not in ref
    assert {"post_norm1", "post_norm2"} <= set(ref["stages"]["attn_global_1"])


def test_param_shapes_and_windows():
    cfg = get_config(ARCH)
    shapes = param_shapes(cfg)
    assert "head" not in shapes
    assert tuple(shapes["stages"]["attn_local_0"]["attn"]["wq"].shape) == (13, 2304, 2048)
    assert tuple(shapes["stages"]["attn_global_1"]["post_norm2"]["scale"].shape) == (13, 2304)
    assert [window_for(cfg, k) for k in cfg.pattern] == [4096, None]
    model = Transformer(A.cfgs(ARCH)[1], device="meta", seed=None)
    assert [m.attn.window for m in model.stages[0].values()] == [64, None]


@pytest.mark.parametrize("attn_impl", ["flash", "plain"])
def test_loss_and_every_gradient_match_reference(attn_impl):
    A.check_loss_and_grads(ARCH, attn_impl)


def test_chunked_cross_entropy_with_logit_softcap_matches_reference():
    """vocab >= 64000 and seq 1024: both packages take the chunked-CE
    path, with the logit softcap applied inside each chunk."""
    jcfg, tcfg = A.cfgs(ARCH, vocab=64000, n_layers=2)
    params = A.weights(jcfg)
    b = A.batch(tcfg, batch=1, seq=1024)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, jcfg), has_aux=True)(jax.tree.map(jnp.asarray, params))
    model = A.port_model(tcfg, params)
    loss = model.loss(batch_to_device(b, torch.device("cpu")))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=A.LOSS_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jgrads), tcfg)
    for n, p in model.named_parameters():
        scale = float(np.max(np.abs(want[n])))
        assert float(np.max(np.abs(p.grad.numpy() - want[n]))) <= A.GRAD_REL * scale, n


def test_logit_softcap_bounds_the_logits():
    """Without the softcap the loss differs: the cap is on the path."""
    jcfg, tcfg = A.cfgs(ARCH)
    params = A.weights(jcfg)
    b = batch_to_device(A.batch(tcfg), torch.device("cpu"))
    with torch.no_grad():
        capped = float(A.port_model(tcfg, params).loss(b))
        uncapped = float(A.port_model(dataclasses.replace(tcfg, logit_softcap=None),
                                      params).loss(b))
    assert capped != uncapped


def test_plain_attention_softcap_matches_the_flash_plain_version():
    """``gqa_attention``'s softcap (before the mask, as the JAX jnp path)
    against the flash op's plain version, at the full config's softcap."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 96, h, 32)).astype(np.float32) * 4)
               for h in (4, 2, 2))
    for window in (None, 40):
        got = gqa_attention(q, k, v, window=window, softcap=50.0, q_chunk=32)
        want = flash_attention(q, k, v, window=window, softcap=50.0)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert not torch.allclose(got, gqa_attention(q, k, v, window=window, q_chunk=32))


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_shape_tree_and_unit_costs_match(size):
    A.check_shapes_and_costs(ARCH, size)


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("policy", A.POLICIES)
def test_layout_wire_entries_and_arenas_match(size, policy):
    A.check_layout(ARCH, size, policy)


def test_full_config_parameter_count():
    A.check_full_param_count(ARCH, 2_614_341_888)


@pytest.mark.parametrize("opt,lr", [("sgd", 1e-3), ("adamw", 3e-4)], ids=["sgd", "adamw"])
def test_three_sgd_steps_match_reference(opt, lr):
    """Three steps against the JAX engine's; the name keeps its first
    case's optimizer (``[adamw]`` runs AdamW at lr 3e-4)."""
    A.check_three_steps(ARCH, opt, lr)


def test_post_and_dag_are_bitwise_equal_with_tied_embeddings():
    eng = A.check_post_equals_dag(ARCH)
    assert eng.sync.group_names[-1] == ["embed"]


def test_launcher_runs_gemma2():
    res = A.check_launcher(ARCH)
    assert res.engine.cfg.post_norm and res.engine.cfg.logit_softcap == 30.0
