"""Sharded serving parity: the port's ``serving/sharded.py``, the engine's
``mesh=``, the serve group collectives and measured serve fabrics of
``planning/serve.py``, and the launcher's ``--sharded`` / ``--measure-comm``,
against the JAX package's.

* ``stack_fresh_rows`` / ``write_fresh_rows`` bitwise the JAX functions on
  caches filled from one numpy seed (windowed rings wrapped, global caches,
  a mixed arch); a recurrent-only arch has no payload.
* The at-rest placements follow the JAX ``PartitionSpec`` trees position
  for position (params and caches).
* ``make_group_collective`` on 1 gloo rank: one ``issue()`` per group,
  outputs equal to the group's payload, the stage-count ``ValueError``;
  ``measure_serve_comm`` / ``serve_fabric_fits`` / ``time_serve_groups``:
  the sizes, positive times, the multi-axis ``ValueError``, fits that price
  through ``MeasuredFabric``; the launcher's ``--sharded --measure-comm``
  prints the sharded, fit, measured-plan and per-group lines, with the
  tokens of ``--sharded`` off.
* 4 gloo ranks (one process each) at reduced size, f32, slots 2, max_seq
  20, 3 requests of 8 tokens x 6 (the JAX ``tests/test_serve_exec.py``
  setup): for (mg_wfbp, gpu_nccl), (wfbp, gpu_nccl) and (synceasgd,
  tpu_v5e) on TinyLlama every rank's tokens equal the unsharded engine's
  and each decode step issues the plan's groups, all all-gathers; reduced
  Mixtral (wfbp, tpu_v5e) issues its groups as all-to-alls; reduced
  RecurrentGemma gives equal tokens; RWKV6 issues nothing.  The wire is
  load-bearing: with rank r's owned slice offset by r, every rank's cache
  rows show the offset in rank r's columns.  ``install_plan`` moves the
  counts to the new plan.  The measured comm agrees on every rank.  The
  reference's own executed path: the JAX sharded engine on 4 virtual
  devices (a subprocess, the same seed-0 weights) gives the same tokens
  and group counts for TinyLlama (mg_wfbp) and Mixtral (wfbp).
* 3 gloo ranks: an all-to-all whose payload does not divide by 3 is padded
  locally and exchanged in one call; leaves whose shard axis does not
  divide by 3 stay replicated.
"""

import contextlib
import io
import json
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from _env import REPO_ROOT, SUBPROC_ENV
from _torch_env import bits, world1
from repro.configs import get_reduced as jax_get_reduced
from repro.launch.specs import param_specs
from repro.models.transformer import init_caches as jax_init_caches
from repro.models.transformer import init_params
from repro.serving import serving_cache_pspecs as jax_cache_pspecs
from repro.serving import serving_param_pspecs as jax_param_pspecs
from repro.serving import stack_fresh_rows as jax_stack_fresh_rows
from repro.serving import write_fresh_rows as jax_write_fresh_rows
from repro_torch.configs import get_reduced
from repro_torch.fabric import MeasuredFabric
from repro_torch.fabric.ops import issue
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import from_jax_params, param_shapes
from repro_torch.models.transformer import init_caches, tree_leaves
from repro_torch.planning import (
    build_serve_plan,
    make_group_collective,
    measure_serve_comm,
    serve_fabric_fits,
    time_serve_groups,
)
from repro_torch.serving import (
    serving_cache_pspecs,
    serving_param_pspecs,
    stack_fresh_rows,
    write_fresh_rows,
)

WORLD = 4
TL, MIX = "tinyllama-1.1b", "mixtral-8x7b"
CELLS = [("mg_wfbp", "gpu_nccl"), ("wfbp", "gpu_nccl"), ("synceasgd", "tpu_v5e")]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_all(procs, timeout):
    """Wait for every process (each within ``timeout`` seconds) and return
    the last stdout line of each, parsed as JSON; kills what is left."""
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            assert p.returncode == 0, stderr[-3000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


# ---------------------------------------------------------------------------
# In process: fresh rows, placements, one rank
# ---------------------------------------------------------------------------


def _filled_caches(arch, max_seq, seed):
    """The JAX and the port cache trees of reduced ``arch`` (batch 2, f32),
    every float leaf filled with the same numpy draws."""
    jcfg = jax_get_reduced(arch, param_dtype=jnp.float32)
    tcfg = get_reduced(arch, param_dtype=torch.float32)
    jc = jax_init_caches(jcfg, batch=2, max_seq=max_seq, dtype=jnp.float32)
    tc = init_caches(tcfg, 2, max_seq, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    jleaves, treedef = jax.tree.flatten(jc)
    tleaves = tree_leaves(tc)
    assert [tuple(a.shape) for a in jleaves] == [tuple(t.shape) for t in tleaves]
    filled = []
    for a, t in zip(jleaves, tleaves):
        if jnp.issubdtype(a.dtype, jnp.floating):
            v = rng.standard_normal(a.shape).astype(np.float32)
            t.copy_(torch.from_numpy(v))
            a = jnp.asarray(v)
        filled.append(a)
    return jcfg, tcfg, jax.tree.unflatten(treedef, filled), tc


@pytest.mark.parametrize("arch", [TL, "gemma2-2b", MIX, "recurrentgemma-9b", "rwkv6-7b"])
def test_fresh_rows_round_trip_matches_reference(arch):
    jcfg, tcfg, jc, tc = _filled_caches(arch, max_seq=100, seed=3)
    for pos in (3, 70, 99):  # 70 and 99 wrap a 64-key window
        want = jax_stack_fresh_rows(jcfg, jc, jnp.asarray(pos, jnp.int32))
        got = stack_fresh_rows(tcfg, tc, torch.tensor(pos))
        if arch == "rwkv6-7b":
            assert want is None and got is None
            continue
        assert got.shape == want.shape and got.shape[0] == tcfg.n_stages
        assert np.array_equal(bits(got), bits(np.asarray(want)))
        rows = np.random.default_rng(pos).standard_normal(tuple(got.shape)).astype(np.float32)
        jw = jax_write_fresh_rows(jcfg, jc, jnp.asarray(rows), jnp.asarray(pos, jnp.int32))
        tw = write_fresh_rows(tcfg, tc, torch.from_numpy(rows), torch.tensor(pos))
        for a, t in zip(jax.tree.leaves(jw), tree_leaves(tw)):
            assert np.array_equal(bits(t), bits(np.asarray(a)))
        assert np.array_equal(bits(stack_fresh_rows(tcfg, tc, pos)), bits(rows))
        jc = jw


def _spec_axis(spec):
    """The position of ``'model'`` in a JAX ``PartitionSpec`` (None: replicated)."""
    names = tuple(spec)
    return names.index("model") if "model" in names else None


def _placement_axis(p):
    return p.dim if isinstance(p, Shard) else None


@pytest.mark.parametrize("arch", [TL, MIX, "recurrentgemma-9b"])
def test_placements_follow_reference_pspecs(arch):
    jcfg = jax_get_reduced(arch, param_dtype=jnp.float32)
    tcfg = get_reduced(arch, param_dtype=torch.float32)
    jspec = jax_param_pspecs(param_specs(jcfg))
    tspec = serving_param_pspecs(param_shapes(tcfg))
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    want = [_spec_axis(s) for s in jax.tree.leaves(jspec, is_leaf=is_p)]
    got = [_placement_axis(p) for p in tree_leaves(tspec)]
    assert got == want and any(a is not None for a in got)
    assert all(isinstance(p, (Shard, Replicate)) for p in tree_leaves(tspec))
    _, _, jc, tc = _filled_caches(arch, max_seq=16, seed=0)
    want = [_spec_axis(s) for s in jax.tree.leaves(jax_cache_pspecs(jcfg, jc), is_leaf=is_p)]
    got = [_placement_axis(p) for p in tree_leaves(serving_cache_pspecs(tc))]
    assert got == want and any(a is not None for a in got)


def _plan(arch, policy="mg_wfbp", fabric="gpu_nccl", **kw):
    cfg = get_reduced(arch, param_dtype=torch.float32)
    return cfg, build_serve_plan(cfg, param_shapes(cfg), fabric, {"model": WORLD},
                                 batch_rows=2, policy=policy, **kw)


@pytest.mark.parametrize("op", ["all_gather", "all_to_all", "all_reduce"])
def test_group_collective_one_issue_per_group_on_one_rank(op):
    world1()
    cfg, plan = _plan(TL, "wfbp", op=op)
    groups = plan.schedule.groups
    assert len(groups) > 1
    wire = make_group_collective(plan)
    stacked = torch.from_numpy(
        np.random.default_rng(1).standard_normal((cfg.n_stages, 37)).astype(np.float32))
    before = issue.calls
    outs = wire(stacked)
    assert issue.calls - before == len(groups) == len(outs)
    for (lo, hi), out in zip(groups, outs):
        flat = stacked[lo - 1 : hi].reshape(-1)
        want = flat[None] if op != "all_reduce" else flat
        assert torch.equal(out, want)
    again = wire(stacked * 2)  # the output buffers are the plan's own, reused
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(outs, again))
    with pytest.raises(ValueError, match="stages"):
        wire(stacked[:-1])
    assert issue.calls - before == 2 * len(groups)


def test_measured_serve_fabric_on_one_rank():
    world1()
    mesh = make_mesh((1,), ("model",), device_type="cpu")
    sizes = (4096, 65536)
    before = issue.calls
    mc = measure_serve_comm(mesh, "all_gather", ("model",), sizes_bytes=sizes, repeats=2)
    assert mc.sizes_bytes == sizes and mc.axes == ("model",) and mc.name == "all_gather@model"
    assert len(mc.times_s) == 2 and all(t > 0 for t in mc.times_s)
    assert issue.calls > before  # through the counted seam
    with pytest.raises(ValueError, match="one axis"):
        measure_serve_comm(mesh, "all_gather", ("model", "data"))
    fits = serve_fabric_fits(mesh, ops=("all_gather", "all_to_all"), sizes_bytes=sizes,
                             repeats=2)
    assert set(fits) == {"all_gather@model", "all_to_all@model"}
    fab = MeasuredFabric(models=fits, name="measured_serve")
    for op in ("all_gather", "all_to_all"):
        m = fab.cost(op, {"model": 1})
        assert (m.a, m.b) == (fits[f"{op}@model"].a, fits[f"{op}@model"].b)
    cfg, plan = _plan(TL, "wfbp")
    cfg, mplan = _plan(TL, "wfbp", fabric=fab)
    assert mplan.fabric == "measured_serve"
    times = time_serve_groups(plan, mesh, repeats=2)
    assert len(times) == len(plan.schedule.groups) and all(t > 0 for t in times)


def test_serve_cli_sharded_measure_comm_on_cpu():
    argv = ["--arch", TL, "--reduced", "--device", "cpu", "--slots", "2", "--requests", "3",
            "--prompt-len", "8", "--tokens", "4", "--fabric", "gpu_nccl"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = serve_cli.run(argv + ["--sharded", "--measure-comm"])
    out = buf.getvalue()
    plain = serve_cli.run(argv, quiet=True)
    assert "only 1 devices visible; clamping TP 8 -> 1" in out
    assert "3 requests, 12 tokens" in out and "sharded TP=1" in out
    assert "measured fit all_gather@model: a=" in out
    assert "measured-fabric plan: serve_plan[mg_wfbp|measured_serve|all_gather]" in out
    assert "per-group predicted vs measured:" in out
    n_groups = len(res.plan.schedule.groups)
    assert out.count(" meas=") == n_groups == len(res.timer.group_times)
    assert res.engine.mesh is not None and plain.engine.mesh is None
    assert {r.rid: r.generated for r in res.completed} == \
        {r.rid: r.generated for r in plain.completed}


# ---------------------------------------------------------------------------
# Several gloo ranks, and the JAX engine on 4 virtual devices
# ---------------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.configs import get_reduced
    from repro.launch.specs import param_specs
    from repro.models.transformer import init_params
    from repro.planning import build_serve_plan
    from repro.serving import Request, ServingEngine

    mesh = make_mesh((4,), ("model",))
    out = {}
    for arch, policy, fabric in (("tinyllama-1.1b", "mg_wfbp", "gpu_nccl"),
                                 ("mixtral-8x7b", "wfbp", "tpu_v5e")):
        cfg = get_reduced(arch, param_dtype=jnp.float32)
        params = init_params(jax.random.PRNGKey(0), cfg)
        plan = build_serve_plan(cfg, param_specs(cfg), fabric, {"model": 4},
                                batch_rows=2, policy=policy)
        eng = ServingEngine(cfg, params, slots=2, max_seq=20, plan=plan, mesh=mesh)
        rng = np.random.default_rng(0)
        for rid in range(3):
            eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, size=8,
                                                            dtype=np.int32),
                               max_new_tokens=6))
        done = eng.run_to_completion()
        out[arch] = {"tokens": {str(r.rid): [int(t) for t in r.generated] for r in done},
                     "groups": len(plan.schedule.groups), "op": plan.op}
    print(json.dumps(out))
""")

RANK_SCRIPT = textwrap.dedent("""
    import contextlib, io, json, sys
    import numpy as np
    import torch, torch.distributed as dist

    rank, world, port, d, mode = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                  sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    import repro_torch.planning.serve as serve_mod
    import repro_torch.serving.sharded as sharded
    from repro_torch.configs import get_reduced
    from repro_torch.fabric import MeasuredFabric
    from repro_torch.fabric.ops import issue
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Transformer, load_arrays, param_shapes, to_jax_params
    from repro_torch.models.transformer import init_caches
    from repro_torch.planning import (build_serve_plan, make_group_collective,
                                      measure_serve_comm, serve_fabric_fits,
                                      time_serve_groups)
    from repro_torch.serving import (Request, ServingEngine, shard_serving_state,
                                     stack_fresh_rows)

    mesh = make_mesh((world,), ("model",), device_type="cpu")
    out = {}
    issued = []  # the op of every collective the serve wire issues

    def recording_issue(op, *args, _issue=serve_mod.issue, **kwargs):
        issued.append(str(getattr(op, "value", op)))
        return _issue(op, *args, **kwargs)

    serve_mod.issue = recording_issue

    def model_for(arch):
        cfg = get_reduced(arch, param_dtype=torch.float32)
        if arch in ("tinyllama-1.1b", "mixtral-8x7b"):  # the JAX seed-0 weights
            model = Transformer(cfg, device="cpu", seed=None)
            load_arrays(model, dict(np.load(f"{d}/{arch}.npz")))
        else:
            model = Transformer(cfg, device="cpu", seed=0)
        return cfg, model

    def plan_for(cfg, policy, fabric):
        return build_serve_plan(cfg, param_shapes(cfg), fabric, {"model": 4},
                                batch_rows=2, policy=policy)

    def submit(eng, cfg, n=3):
        rng = np.random.default_rng(0)
        for rid in range(n):
            eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, size=8,
                                                            dtype=np.int32),
                               max_new_tokens=6))

    def serve(cfg, model, plan, m, install=None):
        eng = ServingEngine(cfg, model, slots=2, max_seq=20, plan=plan, mesh=m)
        submit(eng, cfg)
        issued.clear()
        calls = []
        while eng.active or eng.waiting:
            if install is not None and len(calls) == 2:
                eng.install_plan(install)
            before = issue.calls
            eng.step()
            calls.append(issue.calls - before)
        return {str(r.rid): r.generated for r in eng.completed}, calls

    if mode == "serve":
        cfg, model = model_for("tinyllama-1.1b")
        base, _ = serve(cfg, model, plan_for(cfg, "mg_wfbp", "gpu_nccl"), None)
        out["tl_tokens"] = base
        out["cells"] = {}
        for policy, fabric in (("mg_wfbp", "gpu_nccl"), ("wfbp", "gpu_nccl"),
                               ("synceasgd", "tpu_v5e")):
            plan = plan_for(cfg, policy, fabric)
            toks, calls = serve(cfg, model, plan, mesh)
            out["cells"][f"{policy}|{fabric}"] = {
                "match": toks == base, "calls": calls, "groups": len(plan.schedule.groups),
                "op": plan.op, "issued": sorted(set(issued)), "n_issued": len(issued)}
        # install_plan on a sharded engine: the counts follow the new plan
        mg, wf = plan_for(cfg, "mg_wfbp", "gpu_nccl"), plan_for(cfg, "wfbp", "gpu_nccl")
        toks, calls = serve(cfg, model, mg, mesh, install=wf)
        out["install"] = {"match": toks == base, "calls": calls,
                          "groups": [len(mg.schedule.groups), len(wf.schedule.groups)]}
        # the wire is load-bearing: rank r's owned slice offset by r
        real = sharded.make_group_collective

        def offset(plan, group):
            run = real(plan, group)
            return lambda stacked: run(stacked + dist.get_rank(group))

        sharded.make_group_collective = offset
        eng = ServingEngine(cfg, model, slots=2, max_seq=20, plan=mg, mesh=mesh)
        sharded.make_group_collective = real
        ref = ServingEngine(cfg, model, slots=2, max_seq=20, plan=mg)
        for e in (eng, ref):
            submit(e, cfg, n=1)
            e.step()  # admit at 8 tokens, decode position 8
        got = stack_fresh_rows(cfg, eng._state["caches"], 8)
        want = stack_fresh_rows(cfg, ref._state["caches"], 8)
        width = -(-got.shape[1] // world)
        off = (torch.arange(got.shape[1]) // width).to(got.dtype)
        out["wire_offset"] = bool(torch.equal(got, want + off)) and bool(off.max() == world - 1)
        # MoE: all-to-all groups
        mcfg, mmodel = model_for("mixtral-8x7b")
        mplan = plan_for(mcfg, "wfbp", "tpu_v5e")
        mbase, _ = serve(mcfg, mmodel, mplan, None)
        toks, calls = serve(mcfg, mmodel, mplan, mesh)
        out["moe"] = {"tokens": toks, "match": toks == mbase, "calls": calls,
                      "groups": len(mplan.schedule.groups), "op": mplan.op,
                      "issued": sorted(set(issued)), "n_issued": len(issued)}
        for arch in ("recurrentgemma-9b", "rwkv6-7b"):
            rcfg, rmodel = model_for(arch)
            rplan = plan_for(rcfg, "mg_wfbp", "gpu_nccl")
            rbase, _ = serve(rcfg, rmodel, rplan, None)
            toks, calls = serve(rcfg, rmodel, rplan, mesh)
            out[arch] = {"match": toks == rbase, "calls": calls,
                         "groups": len(rplan.schedule.groups)}
        # measured serve fabrics
        sizes = (4096, 65536)
        mc = measure_serve_comm(mesh, "all_gather", ("model",), sizes_bytes=sizes, repeats=2)
        fits = serve_fabric_fits(mesh, ops=("all_gather", "all_to_all"), sizes_bytes=sizes,
                                 repeats=2)
        fab = MeasuredFabric(models=fits, name="measured_serve")
        try:
            measure_serve_comm(mesh, "all_gather", ("model", "data"))
            multi_axis = False
        except ValueError:
            multi_axis = True
        out["measure"] = {
            "sizes": list(mc.sizes_bytes), "times": list(mc.times_s),
            "fits": {k: [f.a, f.b] for k, f in fits.items()},
            "priced": [fab.cost(op, {"model": 4}).b for op in ("all_gather", "all_to_all")],
            "groups": list(time_serve_groups(mg, mesh, repeats=2)),
            "n_groups": len(mg.schedule.groups), "multi_axis_raises": multi_axis}
        # at-rest layout
        def tensors(tree):
            if isinstance(tree, dict):
                return {k: tensors(v) for k, v in tree.items()}
            return torch.from_numpy(np.ascontiguousarray(tree))

        sp, sc = shard_serving_state(tensors(to_jax_params(model)),
                                     init_caches(cfg, 2, 20, dtype=torch.float32, device="cpu"),
                                     mesh)
        wq = sp["stages"]["attn_0"]["attn"]["wq"]
        k = sc["stages"]["attn_0"][0]
        out["layout"] = {"wq": wq.to_local().numel() / wq.numel(),
                         "wq_placement": str(wq.placements[0]),
                         "k": k.to_local().numel() / k.numel(),
                         "embed": str(sp["embed"].placements[0])}
        # the launcher, sharded and measured, against --sharded off
        argv = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu", "--slots", "2",
                "--requests", "3", "--prompt-len", "8", "--tokens", "4", "--fabric",
                "gpu_nccl", "--virtual-tp", "4"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = serve_cli.run(argv + ["--sharded", "--measure-comm"], model=model)
        plain = serve_cli.run(argv, model=model, quiet=True)
        out["cli"] = {"stdout": buf.getvalue(),
                      "match": {r.rid: r.generated for r in res.completed}
                      == {r.rid: r.generated for r in plain.completed},
                      "groups": len(res.plan.schedule.groups)}
    else:  # 3 ranks: all-to-all padding, non-divisible leaves
        cfg = get_reduced("tinyllama-1.1b", param_dtype=torch.float32)
        plan = build_serve_plan(cfg, param_shapes(cfg), "gpu_nccl", {"model": 3},
                                batch_rows=2, policy="wfbp", op="all_to_all")
        width = 5  # per stage: a group of g stages ships 5g elements, padded to 3
        payload = lambda r: (torch.arange(cfg.n_stages * width, dtype=torch.float32)
                             .reshape(cfg.n_stages, width) + 100 * r)
        wire = make_group_collective(plan)
        before = issue.calls
        outs = wire(payload(rank))
        ok = []
        for (lo, hi), got in zip(plan.schedule.groups, outs):
            n_el = (hi - lo + 1) * width
            chunk = -(-n_el // world)
            pads = [torch.nn.functional.pad(payload(q)[lo - 1:hi].reshape(-1),
                                            (0, chunk * world - n_el)) for q in range(world)]
            want = torch.stack([p[rank * chunk:(rank + 1) * chunk] for p in pads])
            ok.append(bool(torch.equal(got, want)) and n_el % world != 0)
        out["a2a"] = {"ok": ok, "calls": issue.calls - before,
                      "groups": len(plan.schedule.groups)}
        model = Transformer(cfg, device="cpu", seed=0)

        def tensors(tree):
            if isinstance(tree, dict):
                return {k: tensors(v) for k, v in tree.items()}
            return torch.from_numpy(np.ascontiguousarray(tree))

        sp, sc = shard_serving_state(tensors(to_jax_params(model)),
                                     init_caches(cfg, 2, 20, dtype=torch.float32, device="cpu"),
                                     mesh)
        out["layout"] = {
            "wq": str(sp["stages"]["attn_0"]["attn"]["wq"].placements[0]),
            "w_gate": str(sp["stages"]["attn_0"]["mlp"]["w_gate"].placements[0]),
            "k": str(sc["stages"]["attn_0"][0].placements[0])}
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def _ranks(world, d, mode):
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    port = _free_port()
    return [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(world), str(port),
                              str(d), mode],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                             cwd=REPO_ROOT)
            for r in range(world)]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The JAX sharded engine on 4 virtual devices (one subprocess) and the
    port's on 4 gloo ranks (one process each), side by side, on the JAX
    seed-0 weights of reduced TinyLlama and Mixtral."""
    d = tmp_path_factory.mktemp("sharded_serving")
    for arch in (TL, MIX):
        jcfg = jax_get_reduced(arch, param_dtype=jnp.float32)
        tcfg = get_reduced(arch, param_dtype=torch.float32)
        params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
        np.savez(d / f"{arch}.npz", **from_jax_params(params, tcfg))
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SCRIPT], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO_ROOT)]
    procs += _ranks(WORLD, d, "serve")
    outs = _run_all(procs, timeout=300)
    return outs[0], outs[1:]


@pytest.mark.parametrize("cell", [f"{p}|{f}" for p, f in CELLS])
def test_sharded_tokens_and_calls_on_four_ranks(cell, four_ranks):
    _, ranks = four_ranks
    for rec in ranks:
        c = rec["cells"][cell]
        assert c["match"] and c["op"] == "all_gather"
        assert c["calls"] == [c["groups"]] * len(c["calls"]) and len(c["calls"]) >= 6
        assert c["issued"] == ["all_gather"] and c["n_issued"] == sum(c["calls"])
    groups = {p: ranks[0]["cells"][f"{p}|gpu_nccl"]["groups"] for p in ("mg_wfbp", "wfbp")}
    assert groups["wfbp"] > groups["mg_wfbp"]


def test_moe_and_recurrent_archs_on_four_ranks(four_ranks):
    _, ranks = four_ranks
    for rec in ranks:
        moe = rec["moe"]
        assert moe["op"] == "all_to_all" and moe["match"]
        assert moe["issued"] == ["all_to_all"] and moe["n_issued"] == sum(moe["calls"])
        assert moe["calls"] == [moe["groups"]] * len(moe["calls"])
        rg = rec["recurrentgemma-9b"]
        assert rg["match"] and rg["calls"] == [rg["groups"]] * len(rg["calls"])
        rw = rec["rwkv6-7b"]
        assert rw["match"] and sum(rw["calls"]) == 0 and len(rw["calls"]) >= 6


def test_wire_is_load_bearing_on_four_ranks(four_ranks):
    _, ranks = four_ranks
    assert [rec["wire_offset"] for rec in ranks] == [True] * WORLD


def test_install_plan_on_a_sharded_engine(four_ranks):
    _, ranks = four_ranks
    for rec in ranks:
        ins = rec["install"]
        mg, wf = ins["groups"]
        assert ins["match"] and mg != wf
        assert ins["calls"] == [mg, mg] + [wf] * (len(ins["calls"]) - 2)


def test_matches_jax_sharded_engine_on_four_devices(four_ranks):
    ref, ranks = four_ranks
    for rec in ranks:
        assert rec["tl_tokens"] == ref[TL]["tokens"]
        assert rec["cells"]["mg_wfbp|gpu_nccl"]["groups"] == ref[TL]["groups"]
        assert rec["moe"]["tokens"] == ref[MIX]["tokens"]
        assert rec["moe"]["groups"] == ref[MIX]["groups"] and ref[MIX]["op"] == "all_to_all"


def test_measured_serve_fabric_on_four_ranks(four_ranks):
    _, ranks = four_ranks
    m0 = ranks[0]["measure"]
    assert m0["sizes"] == [4096, 65536] and all(t > 0 for t in m0["times"])
    assert len(m0["groups"]) == m0["n_groups"] and all(t > 0 for t in m0["groups"])
    assert set(m0["fits"]) == {"all_gather@model", "all_to_all@model"}
    assert m0["priced"] == [m0["fits"]["all_gather@model"][1], m0["fits"]["all_to_all@model"][1]]
    for rec in ranks:  # every rank holds rank 0's samples
        assert rec["measure"] == m0 and rec["measure"]["multi_axis_raises"]


def test_at_rest_layout_on_four_ranks(four_ranks):
    _, ranks = four_ranks
    for rec in ranks:
        lay = rec["layout"]
        assert lay["wq"] == lay["k"] == 0.25
        assert lay["wq_placement"] == "S(2)" and lay["embed"] == "R"


def test_serve_cli_sharded_on_four_ranks(four_ranks):
    _, ranks = four_ranks
    out = ranks[0]["cli"]["stdout"]
    assert "sharded TP=4" in out and "clamping" not in out
    assert "measured fit all_gather@model: a=" in out and "measured-fabric plan:" in out
    assert out.count(" meas=") == ranks[0]["cli"]["groups"]
    assert all(rec["cli"]["match"] for rec in ranks)


def test_all_to_all_padding_and_replicated_leaves_on_three_ranks(tmp_path):
    outs = _run_all(_ranks(3, tmp_path, "pad"), timeout=120)
    for rec in outs:
        a2a = rec["a2a"]
        assert a2a["calls"] == a2a["groups"] == len(a2a["ok"]) and all(a2a["ok"])
        # 128, 352 and head_dim 32 do not divide by 3: those leaves stay replicated
        assert rec["layout"] == {"wq": "R", "w_gate": "R", "k": "R"}
