"""StarCoder2-3B and -7B (layernorm, the plain GeLU MLP, GQA groups of 2
and 3 at the reduced sizes, 12 and 9 at the full ones) in the port against
the JAX package, on ``get_reduced(<arch>)`` in fp32 on the CPU, from the
same weights.  The checks and their tolerances are ``tests/_torch_arch.py``'s.

The reduced configs have head dim 24, which the CUDA flash kernels do not
take; on the CPU ``attn_impl='flash'`` runs the kernels' plain versions,
which take any head dim.
"""

import pytest
import torch

import _torch_arch as A
from repro_torch.configs import get_config
from repro_torch.models import Transformer, param_shapes

ARCHS = ("starcoder2-3b", "starcoder2-7b")
FULL_PARAMS = {"starcoder2-3b": 3_180_705_792, "starcoder2-7b": 7_399_351_296}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weight_bridge_round_trip_is_exact(arch, dtype):
    """The plain GeLU MLP holds ``w_up`` and ``w_down`` and no ``w_gate``,
    as the reference tree does."""
    ref = A.check_bridge_round_trip(arch, dtype)
    assert set(ref["stages"]["attn_0"]["mlp"]) == {"w_up", "w_down"}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_are_the_published_ones(arch):
    shapes = param_shapes(get_config(arch))
    cfg = get_config(arch)
    mlp = shapes["stages"]["attn_0"]["mlp"]
    assert set(mlp) == {"w_up", "w_down"}
    assert tuple(mlp["w_up"].shape) == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    assert set(shapes["final_norm"]) == {"scale", "bias"}
    assert shapes["head"].dtype == torch.bfloat16 and shapes["embed"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("attn_impl", ["flash", "plain"])
def test_loss_and_every_gradient_match_reference(arch, attn_impl):
    A.check_loss_and_grads(arch, attn_impl)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_shape_tree_and_unit_costs_match(arch, size):
    A.check_shapes_and_costs(arch, size)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("policy", A.POLICIES)
def test_layout_wire_entries_and_arenas_match(arch, size, policy):
    A.check_layout(arch, size, policy)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count(arch):
    A.check_full_param_count(arch, FULL_PARAMS[arch])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("opt,lr", [("sgd", 1e-3), ("adamw", 3e-4)], ids=["sgd", "adamw"])
def test_three_sgd_steps_match_reference(arch, opt, lr):
    """Three steps against the JAX engine's; the name keeps its first
    case's optimizer (``[adamw]`` runs AdamW at lr 3e-4)."""
    A.check_three_steps(arch, opt, lr)


@pytest.mark.parametrize("arch", ARCHS)
def test_post_and_dag_are_bitwise_equal(arch):
    A.check_post_equals_dag(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_runs_the_reduced_arch(arch):
    res = A.check_launcher(arch)
    assert res.engine.cfg.mlp == "gelu" and res.engine.cfg.norm == "layernorm"


def test_gelu_mlp_has_no_gate():
    _, cfg = A.cfgs("starcoder2-3b")
    model = Transformer(cfg, device="meta", seed=None)
    assert not any("w_gate" in n for n, _ in model.named_parameters())
