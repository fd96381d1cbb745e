"""The MoE pair, Mixtral-8x7B (top-2 of 8 experts, a 4096 window on the
``'moe'`` layers' attention) and DBRX-132B (top-4 of 16, layernorm), in the
port against the JAX package, on ``get_reduced(<arch>)`` in fp32 on the
CPU, from the same weights.  The whole-arch checks and their tolerances
are ``tests/_torch_arch.py``'s; the loss holds ``ce + 0.01 x aux``.

``MoEBlock`` is also held alone against the JAX ``moe_block``: the top-k
indices and the kept mask first (a routing flip then shows as a flip, not
as a gradient mismatch), then the output, the aux and every gradient, with
capacity that drops choices and with capacity that drops none.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_arch as A
from repro.core.trainer import lm_unit_costs as jax_lm_unit_costs
from repro.launch.specs import param_specs
from repro.models.common import MoE as JaxMoE
from repro.models.moe import _capacity as jax_capacity, moe_block as jax_moe_block
from repro.planning import build_schedule as jax_build_schedule
from repro_torch.configs import get_config
from repro_torch.core.comm_model import AllReduceModel
from repro_torch.core.trainer import batch_to_device, lm_unit_costs
from repro_torch.models import Transformer, param_shapes
from repro_torch.models.common import MoE
from repro_torch.models.moe import MoEBlock, _capacity, route
from repro_torch.planning import build_schedule

ARCHS = ("mixtral-8x7b", "dbrx-132b")
FULL_PARAMS = {"mixtral-8x7b": 46_702_792_704, "dbrx-132b": 131_597_021_184}


# ---------------------------------------------------------------------------
# MoEBlock alone
# ---------------------------------------------------------------------------


def _jax_routing(p, x, cfg, G=1):
    """The reference block's routing steps (``repro/models/moe.py``) over
    ``G`` token groups: the top-k indices and whether each choice fits its
    expert's capacity."""
    moe = cfg.moe
    B, S, D = x.shape
    tg = B * S // G
    probs = jax.nn.softmax(x.reshape(G, tg, D).astype(jnp.float32) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, moe.top_k)
    onehot = jax.nn.one_hot(idx, moe.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(G, tg * moe.top_k, moe.n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(G, tg, moe.top_k, moe.n_experts)
    pos = jnp.sum(pos * onehot, axis=-1)
    return np.asarray(idx), np.asarray(pos < jax_capacity(tg, moe))


def _block_case(capacity_factor):
    jcfg, tcfg = A.cfgs("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, moe=JaxMoE(4, 2, capacity_factor))
    tcfg = dataclasses.replace(tcfg, moe=MoE(4, 2, capacity_factor))
    p = {k: v[0] for k, v in A.weights(jcfg)["stages"]["moe_0"]["moe"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((A.B, A.S, jcfg.d_model)).astype(np.float32)
    block = MoEBlock(tcfg, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(block, k).copy_(torch.from_numpy(np.array(v)))
    return jcfg, tcfg, p, x, block


def _check_routing(jcfg, tcfg, p, x, block, G):
    """``route`` over ``G`` token groups against the reference's routing;
    returns the kept mask."""
    jidx, jkeep = _jax_routing(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg, G)
    tg = A.B * A.S // G
    assert _capacity(tg, tcfg.moe) == jax_capacity(tg, jcfg.moe)
    with torch.no_grad():
        probs = torch.softmax(torch.from_numpy(x).reshape(G, tg, -1) @ block.router, dim=-1)
        _, idx, _, keep = route(probs, tcfg.moe, _capacity(tg, tcfg.moe))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    return keep


def test_route_over_two_groups_matches_reference():
    """``route`` takes any leading group dimension: at 2 groups each group
    fills its own buffers (the reference's ``moe_groups=2``), and capacity
    drops choices."""
    keep = _check_routing(*_block_case(0.5), G=2)
    assert not keep.all()


@pytest.mark.parametrize("capacity_factor,drops", [(0.5, True), (8.0, False)],
                         ids=["drops", "no_drops"])
def test_moe_block_matches_reference(capacity_factor, drops):
    jcfg, tcfg, p, x, block = _block_case(capacity_factor)
    keep = _check_routing(jcfg, tcfg, p, x, block, G=1)
    assert (not keep.all()) == drops  # capacity drops choices, or none

    rng = np.random.default_rng(4)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    (jout, jaux), vjp = jax.vjp(lambda jp, jx: jax_moe_block(jp, jx, jcfg),
                                jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(cot), jnp.asarray(1.0, jnp.float32)))
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = block(tx)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    for name, want in list(jgp.items()) + [("x", jgx)]:
        got = (tx.grad if name == "x" else getattr(block, name).grad).numpy()
        want = np.asarray(want)
        assert float(np.abs(got - want).max()) <= A.GRAD_REL * float(np.abs(want).max()), name


def test_moe_aux_and_its_router_gradient_match_reference():
    """The load-balance aux alone: its value and its gradient into the
    router (through the mean router probability; the choice fractions,
    dropped choices counted, carry none)."""
    jcfg, tcfg, p, x, block = _block_case(0.5)
    jaux, vjp = jax.vjp(lambda r: jax_moe_block({**p, "router": r}, jnp.asarray(x), jcfg)[1],
                        jnp.asarray(p["router"]))
    (jg,) = vjp(jnp.asarray(1.0, jnp.float32))
    _, aux = block(torch.from_numpy(x))
    aux.backward()
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    assert float(aux.detach()) > 1.0  # E x sum(frac x mean_prob) is 1 under perfect balance
    want = np.asarray(jg)
    assert float(np.abs(block.router.grad.numpy() - want).max()) <= \
        A.GRAD_REL * float(np.abs(want).max())
    assert block.w_gate.grad is None  # the aux reaches the router alone


# ---------------------------------------------------------------------------
# The whole archs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weight_bridge_round_trip_is_exact(arch, dtype):
    """The MoE subtree (an f32 router among bf16 experts) round trips; a
    ``'moe'`` layer holds no ``mlp``."""
    ref = A.check_bridge_round_trip(arch, dtype)
    layer = ref["stages"]["moe_0"]
    assert "mlp" not in layer and set(layer["moe"]) == {"router", "w_gate", "w_up", "w_down"}
    assert layer["moe"]["router"].dtype == np.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_are_the_published_ones(arch):
    cfg = get_config(arch)
    moe = param_shapes(cfg)["stages"]["moe_0"]["moe"]
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    assert {k: tuple(v.shape) for k, v in moe.items()} == {
        "router": (cfg.n_layers, d, E), "w_gate": (cfg.n_layers, E, d, f),
        "w_up": (cfg.n_layers, E, d, f), "w_down": (cfg.n_layers, E, f, d)}
    assert moe["router"].dtype == torch.float32 and moe["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("attn_impl", ["flash", "plain"])
def test_loss_and_every_gradient_match_reference(arch, attn_impl):
    A.check_loss_and_grads(arch, attn_impl)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_leaves_the_checkpointed_layers_once(arch):
    """``remat='full'`` reruns each MoE forward in backward; the aux that
    leaves the checkpointed sublayers is counted once: the summed aux is
    the reference's ``moe_aux``, and the loss and every gradient are those
    of ``remat='none'``."""
    params, _, jaux, _ = A._jax_loss_and_grads(arch)
    _, tcfg = A.cfgs(arch)
    b = batch_to_device(A.batch(tcfg), torch.device("cpu"))
    runs = []
    for remat in ("full", "none"):
        model = A.port_model(dataclasses.replace(tcfg, remat=remat), params)
        calls = []
        for sub in model.sublayers():
            sub.moe.register_forward_pre_hook(lambda *_: calls.append(1))
        _, aux = model.hidden(b["tokens"])
        np.testing.assert_allclose(float(aux.detach()), jaux, rtol=1e-5)
        calls.clear()
        loss = model.loss(b)
        loss.backward()
        runs.append((float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}, len(calls)))
    (l_full, g_full, n_full), (l_none, g_none, n_none) = runs
    assert (n_full, n_none) == (2 * tcfg.n_layers, tcfg.n_layers)
    assert l_full == l_none
    for n in g_full:
        assert torch.equal(g_full[n], g_none[n]), n


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_shape_tree_and_unit_costs_match(arch, size):
    A.check_shapes_and_costs(arch, size)


#: An all-reduce model under which the MoE stages' analytic backward times
#: decide the full configs' mg_wfbp merges.
MOE_AR = dict(a=5e-3, b=1e-11)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_moe_unit_costs_price_the_active_experts(arch, size):
    """A stage's operations count only the active share ``0.25 + 0.75 k/E``
    of its parameters, as the reference prices them, and the mg_wfbp groups
    planned from them are the reference planner's."""
    jcfg, tcfg = A.cfgs(arch) if size == "reduced" else A.full_cfgs(arch)
    shapes = param_shapes(tcfg)
    costs = A.check_shapes_and_costs(arch, size)
    stage_p = costs[1].params
    active = 0.25 + 0.75 * tcfg.moe.top_k / tcfg.moe.n_experts
    assert costs[1].bwd_flops == 4.0 * stage_p * A.TOKENS * active
    assert costs[1].fwd_flops == 2.0 * stage_p * A.TOKENS * active
    for ar in (A.AR, MOE_AR):
        jsched = jax_build_schedule("mg_wfbp", jax_lm_unit_costs(jcfg, param_specs(jcfg), A.TOKENS),
                                    A.JaxAllReduceModel(**ar))
        tsched = build_schedule("mg_wfbp", lm_unit_costs(tcfg, shapes, A.TOKENS),
                                AllReduceModel(**ar))
        assert tsched.groups == jsched.groups


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
    """The ``dag`` hooks see f32 router gradients beside bf16-sized expert
    ones in one unit; both orders give the same bits."""
    A.check_post_equals_dag(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_runs_the_reduced_arch(arch):
    res = A.check_launcher(arch)
    assert res.engine.cfg.moe is not None
    assert sum(1 for n, _ in res.model.named_parameters() if n.endswith(".moe.router")) == 4


def test_moe_kind_without_moe_options_raises():
    _, cfg = A.cfgs("mixtral-8x7b")
    with pytest.raises(NotImplementedError, match="moe"):
        Transformer(dataclasses.replace(cfg, moe=None), device="meta", seed=None)
