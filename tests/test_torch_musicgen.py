"""MusicGen-large (embeds input, additive sinusoidal positions, MHA at head
dim 64, layernorm, the plain GeLU MLP) in the port against the JAX package,
on ``get_reduced('musicgen-large')`` in fp32 on the CPU, from the same
weights and the same embeds batches.  The checks and their tolerances are
``tests/_torch_arch.py``'s.

The sinusoid follows the JAX forward's offset rule: an int ``q_offset``
places its rows at that offset, a traced one (the jitted decode step, the
JAX engine's) at 0.  The port reads a tensor offset as the traced one.
With int offsets a decode step equals the full forward; with a tensor
offset it equals the jitted JAX step and not the full forward, which pins
the rule.
"""

import numpy as np
import pytest
import torch

import _torch_arch as A
from repro.models.layers import sinusoidal_embedding as jax_sinusoidal
from repro_torch.configs import get_config
from repro_torch.models import param_shapes
from repro_torch.models.layers import sinusoidal_embedding

ARCH = "musicgen-large"
FULL_PARAMS = 2_424_705_024
PROMPT, STEPS = 64, 4  # the JAX prefill takes whole 32-query chunks


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weight_bridge_round_trip_is_exact(dtype):
    ref = A.check_bridge_round_trip(ARCH, dtype)
    assert set(ref["stages"]["attn_0"]["attn"]) == {"wq", "wk", "wv", "wo"}


def test_param_shapes_are_the_published_ones():
    cfg = get_config(ARCH)
    shapes = param_shapes(cfg)
    att = shapes["stages"]["attn_0"]["attn"]
    assert tuple(att["wk"].shape) == (48, 2048, 32 * 64)  # MHA: as many KV heads as queries
    assert set(shapes["stages"]["attn_0"]["mlp"]) == {"w_up", "w_down"}
    assert set(shapes["final_norm"]) == {"scale", "bias"}
    assert tuple(shapes["embed"].shape) == (2048, 2048) and tuple(shapes["head"].shape) == (2048, 2048)


@pytest.mark.parametrize("attn_impl", ["flash", "plain"])
def test_loss_and_every_gradient_match_reference(attn_impl):
    """The embed table's gradient is exactly zero in JAX and absent in
    autograd: the loss reads the batch's embeds, never the table."""
    A.check_loss_and_grads(ARCH, attn_impl)


def test_nope_loss_and_gradients_match_reference():
    """``rope='none'`` (no positions at all) against the JAX model."""
    A.check_loss_and_grads(ARCH, "flash", att=(("rope", "none"),))


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
    """Three steps against the JAX engine's; the zero embed gradient rides
    its group's all-reduce and AdamW's weight decay moves the table."""
    A.check_three_steps(ARCH, opt, lr)


def test_post_and_dag_are_bitwise_equal():
    A.check_post_equals_dag(ARCH)


def test_launcher_runs_the_reduced_arch():
    res = A.check_launcher(ARCH)
    assert res.engine.cfg.input_mode == "embeds"


@pytest.mark.parametrize("S,dim,offset", [(1, 128, 0), (37, 128, 0), (1, 128, 45), (64, 2048, 3)])
def test_sinusoidal_embedding_is_bitwise_the_reference(S, dim, offset):
    want = np.asarray(jax_sinusoidal(S, dim, offset=offset))
    got = sinusoidal_embedding(S, dim, offset, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.numpy().tobytes() == want.tobytes()


def test_decode_with_int_offsets_equals_the_full_forward():
    """Un-jitted JAX steps (Python ``pos``) and the port's with int ``pos``:
    each step at its own sinusoid row; the port's equal to the JAX step's
    (the bf16 prefill cache both keep) and, with an f32 cache, to the full
    forward."""
    for got, jax_step, got_f32, full in A.serving_steps(ARCH, PROMPT, STEPS, jit=False,
                                                        tensor_pos=False):
        A.close_logits(got, jax_step)
        A.close_logits(got_f32, full)


def test_decode_with_a_tensor_offset_is_the_jitted_reference():
    """The jitted JAX step traces ``pos``, so its forward adds position 0's
    sinusoid row; the port's step given ``pos`` as a tensor does the same.
    The steps leave the full forward (the port's, with an f32 cache) by far
    more than the tolerance."""
    out = A.serving_steps(ARCH, PROMPT, STEPS, jit=True, tensor_pos=True)
    got0, jax0, got0_f32, full0 = out[0]  # the prefill: positions 0.., both ways
    A.close_logits(got0, jax0)
    A.close_logits(got0_f32, full0)
    for got, jax_step, got_f32, full in out[1:]:
        A.close_logits(got, jax_step)
        assert A.rel_diff(got_f32, full) > 100 * A.LOGIT_REL


def test_engine_matches_reference_engine():
    """The two engines decode every token at sinusoid position 0 (ROADMAP C)
    and agree token for token."""
    A.check_engine(ARCH)
