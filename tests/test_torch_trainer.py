"""Trainer parity: 3 MG-WFBP steps of reduced tinyllama (fp32, AdamW or
SGD, ``fuse='arena'``, ``mg_wfbp``) in the port against the JAX package's
``make_train_step`` on a 1-device mesh, from the same weights and
batches; and the port's ``post`` and ``dag`` issue orders bitwise equal.

Tolerances.  The forward/backward agree to ~1e-6 relative (see
``test_torch_model``), so losses must agree to rtol 1e-5.  With SGD
(momentum 0.9) the update is linear in the gradient: every parameter must
agree to max-abs 1e-5 x (1 + max|p|).  AdamW divides by sqrt(v): an
element whose gradient is ~0 on both sides (|g| near eps) can take a
visibly different update from a last-ulp gradient difference, so every
element must lie within 2 x lr x steps (the most such a flip can move it)
and all but 1e-4 of the elements within 1e-6.  Measured on these inputs:
22 of 803,968 elements above 1e-6, the largest 6.4e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.compat import make_mesh, set_mesh
from repro.configs import get_reduced as jax_get_reduced
from repro.core.comm_model import AllReduceModel as JaxAllReduceModel
from repro.core.sync import SyncConfig as JaxSyncConfig
from repro.core.trainer import MGWFBPEngine as JaxEngine
from repro.launch.specs import param_specs
from repro.models.transformer import init_params
from repro.optim import make_optimizer as jax_make_optimizer
from _torch_env import world1
from repro_torch.configs import get_reduced
from repro_torch.core.comm_model import AllReduceModel
from repro_torch.core.sync import SyncConfig
from repro_torch.core.trainer import MGWFBPEngine, batch_to_device
from repro_torch.data import DataConfig, make_stream
from repro_torch.fabric.ops import issue
from repro_torch.kernels.comm_pack import pack_arena, reset_counts, unpack_arena
from repro_torch.models import Transformer, from_jax_params, load_arrays, param_shapes
from repro_torch.optim import make_optimizer

ARCH = "tinyllama-1.1b"
B, S, STEPS, LR = 2, 64, 3, 1e-3
AR = dict(a=1e-8, b=1e-11)  # gives mg_wfbp 3 groups on reduced: [1..4] [5] [6]
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5


def _batches():
    data = make_stream(DataConfig(vocab=256, seq_len=S, global_batch=B))
    return [data.batch_at(i) for i in range(STEPS)]


def _weights():
    jcfg = jax_get_reduced(ARCH, param_dtype=jnp.float32)
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))


def _optimizers(name):
    if name == "sgd":
        return make_optimizer("sgd", momentum=0.9), jax_make_optimizer("sgd", momentum=0.9)
    return make_optimizer("adamw"), jax_make_optimizer("adamw")


def _port_run(issue_order, compression=None, policy="mg_wfbp", opt="adamw"):
    world1()
    cfg = get_reduced(ARCH, param_dtype=torch.float32)
    eng = MGWFBPEngine.build(
        cfg, param_shapes(cfg), ar_model=AllReduceModel(**AR), tokens_per_device=B * S,
        policy=policy, sync_config=SyncConfig(fuse="arena", compression=compression),
    )
    model = Transformer(cfg, device="cpu", seed=None)
    load_arrays(model, from_jax_params(_weights(), cfg))
    step = eng.make_train_step(model, _optimizers(opt)[0], lr=LR, issue=issue_order)
    issue.calls = 0
    reset_counts()
    losses = [float(step(batch_to_device(b, torch.device("cpu")))["loss"]) for b in _batches()]
    counts = (issue.calls, pack_arena.ref_calls, unpack_arena.ref_calls, pack_arena.launches)
    step.close()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return eng, losses, params, counts, step


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_three_steps_match_reference(opt):
    jcfg = jax_get_reduced(ARCH, param_dtype=jnp.float32)
    jeng = JaxEngine.build(
        jcfg, param_specs(jcfg), dp_axes=("data",), ar_model=JaxAllReduceModel(**AR),
        tokens_per_device=B * S, policy="mg_wfbp", sync_config=JaxSyncConfig(fuse="arena"),
    )
    mesh = make_mesh((1,), ("data",))
    jopt = _optimizers(opt)[1]
    jstep = jeng.make_train_step(jopt, mesh, lr=LR)
    params = jax.tree.map(jnp.asarray, _weights())
    state = jopt.init(params)
    jlosses = []
    with set_mesh(mesh):
        for b in _batches():
            params, state, m = jstep(params, state, {k: jnp.asarray(v) for k, v in b.items()})
            jlosses.append(float(m["loss"]))

    eng, losses, tparams, counts, _ = _port_run("post", opt=opt)
    assert eng.schedule.groups == jeng.schedule.groups
    assert len(eng.schedule.groups) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, params), eng.cfg)
    errs = []
    for n, p in tparams.items():
        err = np.abs(p.numpy() - want[n])
        if opt == "sgd":
            assert err.max() <= PARAM_TOL * (1.0 + np.abs(want[n]).max()), (n, err.max())
        errs.append(err.ravel())
    errs = np.concatenate(errs)
    if opt == "adamw":
        assert errs.max() <= 2 * LR * STEPS
        assert (errs > 1e-6).mean() <= 1e-4


@pytest.mark.parametrize("compression", [None, "bf16_ef"])
def test_post_and_dag_are_bitwise_equal(compression):
    eng, l_post, p_post, c_post, s_post = _port_run("post", compression)
    _, l_dag, p_dag, c_dag, s_dag = _port_run("dag", compression)
    assert l_post == l_dag
    for n in p_post:
        assert torch.equal(p_post[n], p_dag[n]), n
    if compression:
        for n in s_post.residual:
            assert torch.equal(s_post.residual[n], s_dag.residual[n]), n
    groups = len(eng.schedule.groups)
    # one issue(), one pack and one unpack per group per step; the CPU
    # tensors take the plain versions, so no kernel launches
    assert c_post == c_dag == (groups * STEPS, groups * STEPS, groups * STEPS, 0)


def test_dag_issues_groups_inside_backward_in_landing_order():
    """wfbp on reduced: 6 groups, and the dag order starts the head group
    first and the embed group last (backward order)."""
    world1()
    cfg = get_reduced(ARCH, param_dtype=torch.float32)
    eng = MGWFBPEngine.build(
        cfg, param_shapes(cfg), ar_model=AllReduceModel(**AR), tokens_per_device=B * S,
        policy="wfbp", sync_config=SyncConfig(fuse="arena"),
    )
    model = Transformer(cfg, device="cpu", seed=0)
    step = eng.make_train_step(model, make_optimizer("sgd"), lr=LR, issue="dag")
    started = []
    orig = eng.sync.start_group

    def spy(gi, *a, **k):
        started.append((gi, model.embed.grad is not None))
        return orig(gi, *a, **k)

    eng.sync.start_group = spy
    step(batch_to_device(_batches()[0], torch.device("cpu")))
    step.close()
    assert [gi for gi, _ in started] == list(range(6))
    # every group but the embed group went out before the embed gradient landed
    assert [landed for _, landed in started] == [False] * 5 + [True]


def test_launch_flags_are_checked():
    world1()
    cfg = get_reduced(ARCH, param_dtype=torch.float32)
    eng = MGWFBPEngine.build(
        cfg, param_shapes(cfg), ar_model=AllReduceModel(**AR), tokens_per_device=B * S,
        sync_config=SyncConfig(fuse="arena"),
    )
    with pytest.raises(ValueError, match="policy"):
        MGWFBPEngine.build(cfg, None, plan=eng.plan, policy="wfbp")
    with pytest.raises(ValueError, match="issue order"):
        eng.make_train_step(Transformer(cfg, device="meta", seed=None),
                            make_optimizer("sgd"), issue="later")
    assert eng.with_plan(eng.plan).schedule.groups == eng.schedule.groups
