"""Whole-arch parity checks of the PyTorch port against the JAX package,
shared by the per-family test files (``tests/test_torch_starcoder2.py``,
``test_torch_gemma2.py``, ``test_torch_moe.py``).

Every check runs one arch's ``get_reduced`` config in fp32 on the CPU from
the same weights (``from_jax_params`` of the reference's ``init_params``)
and the same batch.  Tolerances are those of ``tests/test_torch_model.py``:
loss rtol 1e-5 and every gradient leaf max-abs <= 1e-4 x that leaf's max
|g|; the three-step runs use those of
``tests/test_torch_recurrentgemma.py::test_three_sgd_steps_match_reference``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
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
from repro.models.transformer import init_params
from repro.optim import make_optimizer as jax_make_optimizer
from repro.planning import build_schedule as jax_build_schedule
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import bucketing
from repro_torch.core.comm_model import AllReduceModel
from repro_torch.core.sync import SyncConfig
from repro_torch.core.trainer import MGWFBPEngine, batch_to_device, lm_unit_costs, unread_params
from repro_torch.data import DataConfig, make_stream
from repro_torch.fabric.ops import issue
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.comm_pack import reset_counts as reset_pack_counts
from repro_torch.models import Transformer, from_jax_params, load_arrays, param_shapes, to_jax_params
from repro_torch.models.transformer import ATTN_KINDS
from repro_torch.optim import make_optimizer
from repro_torch.planning import build_schedule

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
B, S = 2, 128  # longer than the reduced configs' 64-key windows
AR = dict(a=1e-8, b=1e-11)
TOKENS = 2048
POLICIES = ("wfbp", "mg_wfbp", "synceasgd")


def cfgs(arch, dtype="f32", attn_impl="flash", att=(), **kw):
    """(reference config, port config); ``attn_impl`` is the port's (the
    reference model runs its jnp attention); ``att`` holds (field, value)
    pairs that replace fields of both configs' ``Attention`` (e.g.
    ``(('qk_norm', True),)``)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = jax_get_reduced(arch, param_dtype=jdt, **kw)
    tcfg = get_reduced(arch, param_dtype=tdt, attn_impl=attn_impl, **kw)
    if att:
        jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(jcfg.attention, **dict(att)))
        tcfg = dataclasses.replace(tcfg, attention=dataclasses.replace(tcfg.attention, **dict(att)))
    return jcfg, tcfg


def full_cfgs(arch):
    return jax_get_config(arch), get_config(arch)


def weights(jcfg, seed=0):
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed), jcfg))


def batch(cfg, batch=B, seq=S, step=0):
    """Step ``step``'s batch of the shared stream: tokens, or embeds for an
    embeds-input arch (``cfg`` of either package)."""
    return make_stream(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                  input_mode=cfg.input_mode, d_model=cfg.d_model)).batch_at(step)


def port_model(tcfg, np_params):
    model = Transformer(tcfg, device="cpu", seed=None)
    load_arrays(model, from_jax_params(np_params, tcfg))
    return model


def check_bridge_round_trip(arch, dtype, att=()):
    """``to_jax_params(from_jax_params(w))`` is ``w``, bit for bit, in the
    reference's tree structure and dtypes."""
    jcfg, tcfg = cfgs(arch, dtype, att=att)
    ref = weights(jcfg)
    back = to_jax_params(port_model(tcfg, ref))
    jl, jt = jax.tree_util.tree_flatten_with_path(ref)
    bl, bt = jax.tree_util.tree_flatten_with_path(back)
    assert jt == bt
    for (p, a), (_, b) in zip(jl, bl):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(bits(a), bits(b))
    return ref


@functools.cache
def _jax_loss_and_grads(arch, att=()):
    jcfg, tcfg = cfgs(arch, att=att)
    params = weights(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch(tcfg).items()}
    (jloss, metrics), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, jcfg), has_aux=True
    )(jax.tree.map(jnp.asarray, params))
    return (params, float(jloss), float(metrics["moe_aux"]),
            from_jax_params(jax.tree.map(np.asarray, jgrads), tcfg))


def check_loss_and_grads(arch, attn_impl, att=()):
    """The loss and every gradient leaf against ``jax.value_and_grad`` of
    the reference ``loss_fn``.  A parameter the loss does not read
    (``unread_params``: an untied embeds arch's ``embed``) has no gradient
    in autograd and an exactly zero one in JAX; it is held as that zero."""
    params, jloss, _, want = _jax_loss_and_grads(arch, att)
    _, tcfg = cfgs(arch, attn_impl=attn_impl, att=att)
    model = port_model(tcfg, params)
    loss = model.loss(batch_to_device(batch(tcfg), torch.device("cpu")))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=LOSS_RTOL)
    unread = unread_params(tcfg)
    for n in unread:
        assert model.get_parameter(n).grad is None
        assert not np.any(want[n]), n
    got = {n: (np.zeros_like(want[n]) if n in unread else p.grad.numpy())
           for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        scale = float(np.max(np.abs(want[n])))
        err = float(np.max(np.abs(got[n] - want[n])))
        assert err <= GRAD_REL * scale, (n, err, scale)


def check_shapes_and_costs(arch, size):
    """The port's stacked shape tree is the reference's, path for path,
    in shape and dtype, and ``lm_unit_costs`` agree field for field."""
    jcfg, tcfg = cfgs(arch) if size == "reduced" else full_cfgs(arch)
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
    return tcosts


def check_layout(arch, size, policy):
    """Layout units, the policy's groups, wire entries and arenas are the
    reference's; every module parameter rides the wire exactly once."""
    jcfg, tcfg = cfgs(arch) if size == "reduced" else full_cfgs(arch)
    jshapes, tshapes = param_specs(jcfg), param_shapes(tcfg)
    jlayout = jax_bucketing.stacked_lm_layout(jshapes, jcfg.n_stages)
    tlayout = bucketing.stacked_lm_layout(tshapes, tcfg.n_stages)
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
    names = [n for g in bucketing.wire_entries(tlayout, tsched) for e in g
             for n in bucketing.entry_param_names(e)]
    assert sorted(names) == sorted(n for n, _ in Transformer(tcfg, device="meta",
                                                             seed=None).named_parameters())


def check_full_param_count(arch, want):
    """The full config's parameter count on the meta device is the
    reference's (``param_specs``, no memory) and the published one."""
    jcfg, tcfg = full_cfgs(arch)
    jcount = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(param_specs(jcfg)))
    meta = Transformer(tcfg, device="meta", seed=None)
    count = sum(p.numel() for p in meta.parameters())
    assert count == jcount == want


def attn_layers(cfg) -> int:
    return sum(k in ATTN_KINDS for k in cfg.block_kinds())


def port_run(arch, issue_order, policy="mg_wfbp", opt="sgd", steps=3, lr=1e-3):
    """``steps`` port steps through ``MGWFBPEngine`` (world 1, gloo, arena
    wire); returns (engine, losses, final parameters, call counts)."""
    world1()
    _, cfg = cfgs(arch)
    eng = MGWFBPEngine.build(
        cfg, param_shapes(cfg), ar_model=AllReduceModel(**AR), tokens_per_device=B * S,
        policy=policy, sync_config=SyncConfig(fuse="arena"),
    )
    model = port_model(cfg, weights(cfgs(arch)[0]))
    optimizer = make_optimizer("sgd", momentum=0.9) if opt == "sgd" else make_optimizer(opt)
    step = eng.make_train_step(model, optimizer, lr=lr, issue=issue_order)
    issue.calls = 0
    reset_pack_counts()
    fa.reset_counts()
    losses = [float(step(batch_to_device(batch(cfg, step=i), torch.device("cpu")))["loss"])
              for i in range(steps)]
    counts = {"issue": issue.calls, "flash_fwd": fa.flash_attention_fwd.ref_calls,
              "flash_dq": fa.flash_attention_dq.ref_calls,
              "flash_dkv": fa.flash_attention_dkv.ref_calls}
    if unread_params(cfg):  # the reduced gradient unpacked into .grad: exactly zero
        counts["unread_grads_zero"] = {
            n: bool(torch.all(model.get_parameter(n).grad == 0)) for n in unread_params(cfg)}
    step.close()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return eng, losses, params, counts


def check_three_steps(arch, opt, lr):
    """Three steps against the reference engine's (``mg_wfbp``, arena wire):
    the same groups, losses at rtol 1e-5; SGD (momentum 0.9) parameters
    element by element within 1e-5 x (1 + max|w|), AdamW's every element
    within 2 x lr x steps and all but 1e-4 of them within 1e-6."""
    jcfg, _ = cfgs(arch)
    jeng = JaxEngine.build(
        jcfg, param_specs(jcfg), dp_axes=("data",), ar_model=JaxAllReduceModel(**AR),
        tokens_per_device=B * S, policy="mg_wfbp", sync_config=JaxSyncConfig(fuse="arena"),
    )
    mesh = make_mesh((1,), ("data",))
    jopt = jax_make_optimizer("sgd", momentum=0.9) if opt == "sgd" else jax_make_optimizer(opt)
    jstep = jeng.make_train_step(jopt, mesh, lr=lr)
    params = jax.tree.map(jnp.asarray, weights(jcfg))
    state = jopt.init(params)
    jlosses = []
    with set_mesh(mesh):
        for i in range(3):
            b = {k: jnp.asarray(v) for k, v in batch(jcfg, step=i).items()}
            params, state, m = jstep(params, state, b)
            jlosses.append(float(m["loss"]))

    eng, losses, tparams, counts = port_run(arch, "post", opt=opt, lr=lr)
    assert eng.schedule.groups == jeng.schedule.groups
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
    for n in unread_params(eng.cfg):  # the zero gradient moved it by weight decay alone
        assert counts["unread_grads_zero"][n]
    n_attn, groups = attn_layers(eng.cfg), len(eng.schedule.groups)
    # the flash forward twice per layer and step (checkpointing reruns it),
    # dQ and dK/dV once, all through the plain versions on the CPU
    counts.pop("unread_grads_zero", None)
    assert counts == {"issue": 3 * groups, "flash_fwd": 3 * 2 * n_attn,
                      "flash_dq": 3 * n_attn, "flash_dkv": 3 * n_attn}


def check_post_equals_dag(arch, policy="wfbp"):
    """``dag`` (each group packed and issued from the gradient hooks inside
    backward) gives the same bits as ``post`` over two AdamW steps."""
    eng, l_post, p_post, c_post = port_run(arch, "post", policy=policy, opt="adamw", steps=2)
    _, l_dag, p_dag, c_dag = port_run(arch, "dag", policy=policy, opt="adamw", steps=2)
    assert l_post == l_dag
    for n in p_post:
        assert torch.equal(p_post[n], p_dag[n]), n
    assert c_post == c_dag
    assert c_post["issue"] == 2 * len(eng.schedule.groups)
    assert all(c_post.get("unread_grads_zero", {}).values())
    return eng


def check_launcher(arch):
    """``repro_torch.launch.train.run`` on the reduced arch, 2 ``dag``
    steps on the CPU; returns its result."""
    from repro_torch.launch.train import run

    world1()
    res = run(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2", "--seq", str(S),
               "--fuse", "arena", "--device", "cpu", "--issue-order", "dag"],
              quiet=True)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    return res


# ---------------------------------------------------------------------------
# Serving: the decode steps and the engine against the JAX package's
# ---------------------------------------------------------------------------

LOGIT_REL = 1e-4  # tests/test_torch_serving.py's tolerance


def close_logits(got, want, rel=LOGIT_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def rel_diff(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def serving_setup(arch, att=()):
    """(reference config, port config, reference params, port model), f32,
    the port's weights bridged from the reference's."""
    jcfg, tcfg = cfgs(arch, att=att)
    params = jax.tree.map(jnp.asarray, weights(jcfg))
    return jcfg, tcfg, params, port_model(tcfg, weights(jcfg))


def serve_inputs(cfg, batch_rows, seq, seed=5):
    """The forward's input for ``seq`` positions of ``batch_rows`` rows from
    the shared stream: ``{'embeds': ...}`` for an embeds arch, else
    ``{'tokens': ...}`` (numpy)."""
    b = batch(cfg, batch=batch_rows, seq=seq, step=seed)
    return {k: v for k, v in b.items() if k != "targets"}


def _slice(inputs, lo, hi):
    return {k: v[:, lo:hi] for k, v in inputs.items()}


def to_port(inputs):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.float32 if k == "embeds" else torch.int64) for k, v in inputs.items()}


def to_jax(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def serving_steps(arch, prompt, steps, *, jit: bool, tensor_pos: bool, att=()):
    """``prompt`` positions prefilled, then ``steps`` decode steps fed the
    stream's next inputs (teacher forcing), in both packages: the JAX steps
    jitted or not (a traced or a Python ``pos``), the port's fed ``pos`` as a
    0-d tensor or an int.  The port runs twice: with the bf16 prefill cache
    that the JAX step keeps (held to the JAX step), and with an f32 one
    (held to the full forward, which rounds no key to bf16).  Returns per
    step (0 = the prefill's last row) the port's logits with the bf16 cache,
    the JAX step's, the port's with the f32 cache and the port's full
    forward's row at that position, all (B, vocab) numpy."""
    from repro.launch.steps import make_decode_step as jax_make_decode_step
    from repro.launch.steps import make_prefill_step as jax_make_prefill_step
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    jcfg, tcfg, params, model = serving_setup(arch, att)
    inputs = serve_inputs(tcfg, 2, prompt + steps)
    max_seq = prompt + steps + 1
    jprefill = jax_make_prefill_step(jcfg, None, max_seq)
    jdecode = jax_make_decode_step(jcfg, None)
    if jit:
        jprefill, jdecode = jax.jit(jprefill), jax.jit(jdecode)
    jl, jcaches = jprefill(params, to_jax(_slice(inputs, 0, prompt)))
    out = [[np.asarray(jl)]]
    for i in range(steps):
        pos = prompt + i
        jl, jcaches = jdecode(params, jcaches, to_jax(_slice(inputs, pos, pos + 1)), pos)
        out.append([np.asarray(jl)])
    tdecode = make_decode_step(tcfg)
    for cache_dtype in (torch.bfloat16, torch.float32):
        tl, tcaches = make_prefill_step(tcfg, max_seq, cache_dtype)(
            model, to_port(_slice(inputs, 0, prompt)))
        got = [tl.numpy()]
        for i in range(steps):
            pos = prompt + i
            tpos = torch.tensor(pos, dtype=torch.int32) if tensor_pos else pos
            tl, tcaches = tdecode(model, tcaches, to_port(_slice(inputs, pos, pos + 1)), tpos)
            got.append(tl.numpy())
        for row, g in zip(out, got):
            row.insert(0 if cache_dtype == torch.bfloat16 else 2, g)
    with torch.inference_mode():
        full = model(**to_port(inputs))[0].numpy()
    for i, row in enumerate(out):
        row.append(full[:, prompt - 1 + i])
    return [tuple(row) for row in out]


def _stream_requests(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, vocab, size=int(rng.choice([6, 10]))).astype(np.int32),
             int(rng.integers(2, 7))) for rid in range(n)]


def check_engine(arch, att=()):
    """One stream through the JAX engine and the port's (reduced, f32, the
    same weights; an embeds arch through both engines' stub frontends):
    three requests, two steps, three more joining mid-flight; the same
    greedy tokens for every request, one decode step built."""
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxServingEngine
    from repro_torch.serving import Request, ServingEngine

    jcfg, tcfg, params, model = serving_setup(arch, att)
    stream = _stream_requests(jcfg.vocab)
    jeng = JaxServingEngine(jcfg, params, slots=2, max_seq=32)
    teng = ServingEngine(tcfg, model, slots=2, max_seq=32)
    for rid, prompt, n in stream[:3]:
        jeng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        teng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    for eng in (jeng, teng):
        eng.step()
        eng.step()
    for rid, prompt, n in stream[3:]:
        jeng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        teng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    want = {r.rid: r.generated for r in jeng.run_to_completion()}
    got = {r.rid: r.generated for r in teng.run_to_completion()}
    assert got == want
    assert len(got) == len(stream)
    assert teng.compile_stats()["decode"] == 1
    return got
