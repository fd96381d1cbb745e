"""RecurrentGemma (Griffin: RG-LRU and local-attention sublayers, a tail,
tied embeddings, gemma norms, GeGLU) in the port against the JAX package,
on ``get_reduced('recurrentgemma-9b')`` in fp32 on the CPU, from the same
weights (``from_jax_params`` of the reference's ``init_params``).

Tolerances are those of ``tests/test_torch_model.py``: loss rtol 1e-5 and
every gradient leaf max-abs <= 1e-4 x that leaf's max |g|.  Both sides work
in f32; they differ in kernels and in summation order, and the reference
runs the recurrence as an associative scan where the port runs it
sequentially (the CUDA kernel's plain version).  The sequence is 128
tokens, so the 64-key window of the local-attention layers masks keys.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_env import bits, world1
from repro.compat import make_mesh, set_mesh
from repro.configs import get_config as jax_get_config, get_reduced as jax_get_reduced
from repro.core import bucketing as jax_bucketing
from repro.core.comm_model import AllReduceModel as JaxAllReduceModel
from repro.core.sync import SyncConfig as JaxSyncConfig
from repro.core.trainer import MGWFBPEngine as JaxEngine
from repro.core.trainer import lm_unit_costs as jax_lm_unit_costs
from repro.launch.specs import param_specs
from repro.models import loss_fn as jax_loss_fn
from repro.models.rglru import rglru_block as jax_rglru_block
from repro.models.transformer import init_params
from repro.optim import make_optimizer as jax_make_optimizer
from repro.planning import build_schedule as jax_build_schedule
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import bucketing
from repro_torch.core.comm_model import AllReduceModel
from repro_torch.core.sync import SyncConfig
from repro_torch.core.trainer import MGWFBPEngine, batch_to_device, lm_unit_costs
from repro_torch.data import DataConfig, make_stream
from repro_torch.fabric.ops import issue
from repro_torch.kernels import rglru as rg
from repro_torch.kernels.comm_pack import reset_counts as reset_pack_counts
from repro_torch.models import Transformer, from_jax_params, load_arrays, param_shapes, to_jax_params
from repro_torch.models.rglru import RGLRUBlock
from repro_torch.optim import make_optimizer
from repro_torch.planning import build_schedule

ARCH = "recurrentgemma-9b"
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
B, S = 2, 128
AR = dict(a=1e-8, b=1e-11)  # mg_wfbp: 3 groups on reduced, [embed, stage 0, stage 1] [tail] [head]
TOKENS = 2048


def _cfgs(dtype="f32", attn_impl="flash", **kw):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jax_get_reduced(ARCH, param_dtype=jdt, **kw),
            get_reduced(ARCH, param_dtype=tdt, attn_impl=attn_impl, **kw))


def _weights(jcfg, seed=0):
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed), jcfg))


def _batch(cfg, batch=B, seq=S, step=0):
    return make_stream(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)).batch_at(step)


def _port_model(tcfg, np_params):
    model = Transformer(tcfg, device="cpu", seed=None)
    load_arrays(model, from_jax_params(np_params, tcfg))
    return model


def _check_loss_and_grads(jcfg, tcfg, batch):
    params = _weights(jcfg)
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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weight_bridge_round_trip_is_exact(dtype):
    """The ``tail`` subtree and the absent ``head`` (tied embeddings) round
    trip, and the f32 leaves among bf16 weights keep their dtype."""
    jcfg, tcfg = _cfgs(dtype)
    ref = _weights(jcfg)
    assert "head" not in ref and "tail" in ref
    back = to_jax_params(_port_model(tcfg, ref))
    jl, jt = jax.tree_util.tree_flatten_with_path(ref)
    bl, bt = jax.tree_util.tree_flatten_with_path(back)
    assert jt == bt
    for (p, a), (_, b) in zip(jl, bl):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(bits(a), bits(b))


def test_param_shapes_keep_the_reference_dtypes():
    shapes = param_shapes(get_config(ARCH))
    assert "head" not in shapes
    mix = shapes["tail"]["rec_0"]["mix"]
    assert {k: v.dtype for k, v in mix.items() if v.dtype == torch.float32} == {
        "ba": torch.float32, "bx": torch.float32, "lam": torch.float32}
    assert mix["wa"].dtype == torch.bfloat16 and shapes["embed"].dtype == torch.float32
    assert shapes["stages"]["attn_local_2"]["attn"]["wk"].shape == (12, 4096, 256)
    assert bucketing.tree_size(shapes) == 9_396_408_320
    assert bucketing.tree_size(param_shapes(get_config(ARCH, n_layers=8))) == 2_831_421_440


def test_rglru_block_matches_reference():
    """The Griffin recurrent block alone: output and the gradients of every
    block parameter and of the input."""
    jcfg, tcfg = _cfgs("f32")
    p = _weights(jcfg)["stages"]["rec_0"]["mix"]
    p = {k: v[0] for k, v in p.items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)

    def jfn(jp, jx):
        return jax_rglru_block(jp, jx, jcfg)[0]

    jout, vjp = jax.vjp(jfn, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(cot))

    block = RGLRUBlock(tcfg, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(block, k).copy_(torch.from_numpy(np.array(v)))
    tx = torch.from_numpy(x).requires_grad_()
    out = block(tx)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for name, want in list(jgp.items()) + [("x", jgx)]:
        got = tx.grad if name == "x" else getattr(block, name).grad
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= GRAD_REL * float(np.abs(want).max()), name


@pytest.mark.parametrize("attn_impl", ["flash", "plain"])
def test_loss_and_every_gradient_match_reference(attn_impl):
    jcfg, tcfg = _cfgs("f32", attn_impl=attn_impl)
    _check_loss_and_grads(jcfg, tcfg, _batch(tcfg))


def test_chunked_cross_entropy_matches_reference():
    """vocab >= 64000 and seq 1024 (> 512, a multiple of it): both packages
    take the chunked-CE path (per-512-token loss under remat); one stage
    plus the tail (5 layers) keeps the run short."""
    jcfg, tcfg = _cfgs("f32", vocab=64000, n_layers=5)
    _check_loss_and_grads(jcfg, tcfg, _batch(tcfg, batch=1, seq=1024))


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_shape_tree_and_unit_costs_match(size):
    jcfg, tcfg = (_cfgs() if size == "reduced" else (jax_get_config(ARCH), get_config(ARCH)))
    jshapes, tshapes = param_specs(jcfg), param_shapes(tcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tleaves = bucketing._subtree_paths(tshapes, ())
    assert [jax_bucketing.normalize_path(tuple(p)) for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(j.shape) == tuple(t.shape)
        assert jnp.dtype(j.dtype).name == bucketing.dtype_name(t.dtype)
    jcosts = jax_lm_unit_costs(jcfg, jshapes, TOKENS)
    tcosts = lm_unit_costs(tcfg, tshapes, TOKENS)
    assert [dataclasses.asdict(c) for c in tcosts] == [dataclasses.asdict(c) for c in jcosts]


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("policy", ["wfbp", "mg_wfbp", "synceasgd"])
def test_layout_wire_entries_and_arenas_match(size, policy):
    jcfg, tcfg = (_cfgs() if size == "reduced" else (jax_get_config(ARCH), get_config(ARCH)))
    jshapes, tshapes = param_specs(jcfg), param_shapes(tcfg)
    jlayout = jax_bucketing.stacked_lm_layout(jshapes, jcfg.n_stages)
    tlayout = bucketing.stacked_lm_layout(tshapes, tcfg.n_stages)
    assert [u.name for u in tlayout.units][-2:] == ["tail", "head"]
    assert [dataclasses.asdict(u) for u in tlayout.units] == [
        dataclasses.asdict(u) for u in jlayout.units]
    jar = JaxAllReduceModel(**AR)
    jsched = jax_build_schedule(policy, jax_lm_unit_costs(jcfg, jshapes, TOKENS), jar)
    tsched = build_schedule(policy, lm_unit_costs(tcfg, tshapes, TOKENS), AllReduceModel(**AR))
    assert tsched.groups == jsched.groups
    assert bucketing.wire_entries(tlayout, tsched) == jax_bucketing.wire_entries(jlayout, jsched)
    ja = jax_bucketing.group_arenas(jlayout, jsched, jshapes)
    ta = bucketing.group_arenas(tlayout, tsched, tshapes)
    assert [(a.size, a.nbytes) for a in ta] == [(a.size, a.nbytes) for a in ja]
    for t, j in zip(ta, ja):
        assert [(s.kind, s.path, s.stack_range, s.offset, s.size, s.shape) for s in t.slots] == [
            (s.kind, s.path, s.stack_range, s.offset, s.size, s.shape) for s in j.slots]
    # every module parameter, tail included, rides the wire exactly once
    names = [n for g in bucketing.wire_entries(tlayout, tsched) for e in g
             for n in bucketing.entry_param_names(e)]
    assert sorted(names) == sorted(n for n, _ in Transformer(tcfg, device="meta",
                                                             seed=None).named_parameters())


def _port_run(issue_order, policy="mg_wfbp", opt="sgd", steps=3, lr=1e-3):
    world1()
    _, cfg = _cfgs("f32")
    eng = MGWFBPEngine.build(
        cfg, param_shapes(cfg), ar_model=AllReduceModel(**AR), tokens_per_device=B * S,
        policy=policy, sync_config=SyncConfig(fuse="arena"),
    )
    model = _port_model(cfg, _weights(_cfgs("f32")[0]))
    optimizer = make_optimizer("sgd", momentum=0.9) if opt == "sgd" else make_optimizer(opt)
    step = eng.make_train_step(model, optimizer, lr=lr, issue=issue_order)
    issue.calls = 0
    reset_pack_counts()
    rg.reset_counts()
    losses = [float(step(batch_to_device(_batch(cfg, step=i), torch.device("cpu")))["loss"])
              for i in range(steps)]
    counts = {"issue": issue.calls, "rglru_fwd": rg.rglru_fwd.ref_calls,
              "rglru_bwd": rg.rglru_bwd.ref_calls}
    step.close()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return eng, losses, params, counts


@pytest.mark.parametrize("opt,lr", [("sgd", 1e-3), ("adamw", 3e-4)], ids=["sgd", "adamw"])
def test_three_sgd_steps_match_reference(opt, lr):
    """Three steps against the JAX package's.  The name keeps its first
    case's optimizer: ``[sgd]`` is SGD (momentum 0.9), and ``[adamw]`` is
    AdamW at the card runs' lr 3e-4, which holds the port's AdamW steps
    (whose losses rise over the card runs) to the reference's.  AdamW uses
    the tolerance form of ``tests/test_torch_trainer.py``: every element
    within 2 x lr x steps, all but 1e-4 of them within 1e-6."""
    jcfg, _ = _cfgs("f32")
    jeng = JaxEngine.build(
        jcfg, param_specs(jcfg), dp_axes=("data",), ar_model=JaxAllReduceModel(**AR),
        tokens_per_device=B * S, policy="mg_wfbp", sync_config=JaxSyncConfig(fuse="arena"),
    )
    mesh = make_mesh((1,), ("data",))
    jopt = jax_make_optimizer("sgd", momentum=0.9) if opt == "sgd" else jax_make_optimizer(opt)
    jstep = jeng.make_train_step(jopt, mesh, lr=lr)
    params = jax.tree.map(jnp.asarray, _weights(jcfg))
    state = jopt.init(params)
    jlosses = []
    with set_mesh(mesh):
        for i in range(3):
            batch = {k: jnp.asarray(v) for k, v in _batch(jcfg, step=i).items()}
            params, state, m = jstep(params, state, batch)
            jlosses.append(float(m["loss"]))

    eng, losses, tparams, counts = _port_run("post", opt=opt, lr=lr)
    assert eng.schedule.groups == jeng.schedule.groups == ((1, 3), (4, 4), (5, 5))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, params), eng.cfg)
    errs = []
    for n, p in tparams.items():
        err = np.abs(p.numpy() - want[n])
        if opt == "sgd":
            assert err.max() <= 1e-5 * (1.0 + float(np.abs(want[n]).max())), (n, err.max())
        errs.append(err.ravel())
    errs = np.concatenate(errs)
    if opt == "adamw":
        assert errs.max() <= 2 * lr * 3
        assert (errs > 1e-6).mean() <= 1e-4
    # 6 RG-LRU layers: the forward twice per step (checkpointing reruns it),
    # the backward once, all through the plain versions on the CPU
    assert counts == {"issue": 3 * 3, "rglru_fwd": 3 * 12, "rglru_bwd": 3 * 6}


def test_post_and_dag_are_bitwise_equal_with_tied_embeddings():
    """wfbp: 5 groups, the embed group alone and last.  Its gradient sums
    the lookup's and every loss chunk's contributions: the post-accumulate
    hook must fire once, after both, or the dag step would pack a partial
    gradient."""
    eng, l_post, p_post, c_post = _port_run("post", policy="wfbp", opt="adamw", steps=2)
    _, l_dag, p_dag, c_dag = _port_run("dag", policy="wfbp", opt="adamw", steps=2)
    assert len(eng.schedule.groups) == 5
    assert eng.sync.group_names[-1] == ["embed"]
    assert l_post == l_dag
    for n in p_post:
        assert torch.equal(p_post[n], p_dag[n]), n
    assert c_post == c_dag == {"issue": 5 * 2, "rglru_fwd": 12 * 2, "rglru_bwd": 6 * 2}


def test_embed_hook_fires_once_on_the_chunked_loss():
    """On the chunked-CE path the tied embedding's gradient arrives from the
    lookup and from each of the 2 loss chunks; its post-accumulate hook
    fires once per backward, with the whole gradient."""
    _, cfg = _cfgs("f32", vocab=64000, n_layers=5)
    model = Transformer(cfg, device="cpu", seed=0)
    fired = []
    model.embed.register_post_accumulate_grad_hook(lambda p: fired.append(p.grad.clone()))
    batch = batch_to_device(_batch(cfg, batch=1, seq=1024), torch.device("cpu"))
    model.loss(batch).backward()
    assert len(fired) == 1
    assert torch.equal(fired[0], model.embed.grad)


def test_launcher_runs_recurrentgemma_with_overrides():
    """The training entry point with ``--arch recurrentgemma-9b`` and a depth
    override (one stage plus the tail), on the CPU."""
    from repro_torch.launch.train import run

    world1()
    res = run(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2", "--seq", "64",
               "--fuse", "arena", "--device", "cpu", "--issue-order", "dag"],
              quiet=True, overrides={"n_layers": 5})
    assert res.engine.cfg.n_layers == 5 and res.engine.cfg.n_stages == 1
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert sum(1 for n, _ in res.model.named_parameters() if ".mix.lam" in n) == 4


def test_unported_options_raise():
    _, cfg = _cfgs("f32")
    with pytest.raises(NotImplementedError, match="pattern"):
        Transformer(dataclasses.replace(cfg, pattern=("xyz",), tail_pattern=(), n_layers=2),
                    device="meta", seed=None)
    # every MLP of the JAX package's token-input archs is ported; an unknown one is not
    with pytest.raises(NotImplementedError, match="mlp"):
        Transformer(dataclasses.replace(cfg, mlp="relu"), device="meta", seed=None)
