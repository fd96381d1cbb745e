"""Qwen2-VL-2B (embeds input, M-RoPE over three equal position streams,
GQA, RoPE theta 1e6, SwiGLU, a 151936-token untied head at full width) in
the port against the JAX package, on ``get_reduced('qwen2-vl-2b')`` in fp32
on the CPU, from the same weights and the same embeds batches.  The checks
and their tolerances are ``tests/_torch_arch.py``'s.

Also here: ``apply_mrope`` against the JAX function, ``qk_norm`` (an option
of the JAX attention no config turns on, here on reduced Qwen2-VL) and the
data stream's embeds batches.  The reduced head dim is 24, which the CUDA
flash kernels do not take; on the CPU ``attn_impl='flash'`` runs their
plain versions, which take any head dim.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_arch as A
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import make_stream as jax_make_stream
from repro.models.layers import apply_mrope as jax_apply_mrope
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_stream
from repro_torch.models import param_shapes
from repro_torch.models.layers import apply_mrope, apply_rope

ARCH = "qwen2-vl-2b"
FULL_PARAMS = 1_777_030_656
QK_NORM = (("qk_norm", True),)
PROMPT, STEPS = 64, 4  # the JAX prefill takes whole 32-query chunks


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("att", [(), QK_NORM], ids=["plain", "qk_norm"])
def test_weight_bridge_round_trip_is_exact(dtype, att):
    """With ``qk_norm`` the tree carries ``q_norm`` / ``k_norm`` (hd,)."""
    ref = A.check_bridge_round_trip(ARCH, dtype, att=att)
    keys = set(ref["stages"]["attn_0"]["attn"])
    assert keys == {"wq", "wk", "wv", "wo"} | ({"q_norm", "k_norm"} if att else set())


def test_param_shapes_are_the_published_ones():
    cfg = get_config(ARCH)
    shapes = param_shapes(cfg)
    att = shapes["stages"]["attn_0"]["attn"]
    assert tuple(att["wq"].shape) == (28, 1536, 12 * 128)
    assert tuple(att["wk"].shape) == (28, 1536, 2 * 128)
    assert tuple(shapes["head"].shape) == (1536, 151936)
    assert shapes["embed"].dtype == torch.float32


@pytest.mark.parametrize("attn_impl", ["flash", "plain"])
def test_loss_and_every_gradient_match_reference(attn_impl):
    A.check_loss_and_grads(ARCH, attn_impl)


def test_qk_norm_loss_and_gradients_match_reference():
    """``qk_norm=True``: forward and every gradient, ``q_norm`` / ``k_norm``
    included."""
    A.check_loss_and_grads(ARCH, "flash", att=QK_NORM)


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_shape_tree_and_unit_costs_match(size):
    A.check_shapes_and_costs(ARCH, size)


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("policy", A.POLICIES)
def test_layout_wire_entries_and_arenas_match(size, policy):
    A.check_layout(ARCH, size, policy)


def test_full_config_parameter_count():
    A.check_full_param_count(ARCH, FULL_PARAMS)


@pytest.mark.parametrize("opt,lr", [("sgd", 1e-3), ("adamw", 3e-4)], ids=["sgd", "adamw"])
def test_three_steps_match_reference(opt, lr):
    A.check_three_steps(ARCH, opt, lr)


def test_post_and_dag_are_bitwise_equal():
    A.check_post_equals_dag(ARCH)


def test_launcher_runs_the_reduced_arch():
    res = A.check_launcher(ARCH)
    assert res.engine.cfg.attention.rope == "mrope"


@pytest.mark.parametrize("hd,sections,theta", [(24, (4, 4, 4), 1e6), (128, (16, 24, 24), 1e6),
                                               (128, (16, 24, 24), 1e4)])
def test_apply_mrope_matches_reference(hd, sections, theta):
    """Three distinct position streams (as an image's t / h / w would be)."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(3, 2, 9)).astype(np.int32)
    want = np.asarray(jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, sections).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("hd,sections", [(24, (4, 4, 4)), (128, (16, 24, 24))])
def test_apply_mrope_on_equal_streams_is_rope(hd, sections):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 9, 3, hd)).astype(np.float32))
    pos = torch.arange(100, 109)[None].expand(2, 9)
    torch.testing.assert_close(apply_mrope(x, pos[None].expand(3, 2, 9), 1e6, sections),
                               apply_rope(x, pos, 1e6), rtol=0, atol=0)


@pytest.mark.parametrize("rank,count", [(0, 1), (1, 2)])
def test_stream_embeds_batches_are_bitwise_the_reference(rank, count):
    """``embeds`` = the seed's table at the step's tokens, and the targets,
    bit for bit; the port draws the table once per stream."""
    kw = dict(vocab=512, seq_len=33, global_batch=4, seed=3, input_mode="embeds", d_model=96)
    t, j = make_stream(DataConfig(**kw), rank, count), jax_make_stream(JaxDataConfig(**kw), rank, count)
    for step in (0, 1, 7):
        tb, jb = t.batch_at(step), j.batch_at(step)
        assert set(tb) == set(jb) == {"embeds", "targets"}
        for k in tb:
            assert tb[k].dtype == jb[k].dtype and tb[k].tobytes() == jb[k].tobytes()


def test_prefill_and_decode_match_reference():
    """The jitted JAX steps against the port's (tensor ``pos``, the bf16
    prefill cache both keep); M-RoPE needs no offset rule, so with an f32
    cache every port step also equals the full forward."""
    for got, jax_step, got_f32, full in A.serving_steps(ARCH, PROMPT, STEPS, jit=True,
                                                        tensor_pos=True):
        A.close_logits(got, jax_step)
        A.close_logits(got_f32, full)


def test_engine_matches_reference_engine():
    A.check_engine(ARCH)


def test_qk_norm_engine_matches_reference_engine():
    A.check_engine(ARCH, att=QK_NORM)
