"""Sync parity: the port's ``make_gradient_sync`` against the JAX
package's, on reduced tinyllama gradients.

* World 1 (gloo, in process) against the reference on a 1-device mesh:
  ``concat``/``arena`` x None/``bf16``/``bf16_ef``, for f32 gradients and
  for the mixed dtypes of the full-width model (f32 embed, bf16 rest).
  Bit-identical, residuals included, and ``issue()`` is called once per
  schedule group.
* World 2: the reference on 2 virtual devices in one subprocess, the port
  as 2 gloo ranks in two more; the reduced gradients and residuals must
  be bit-identical (a two-term sum is exact in either order, and the
  1/2 scale is exact).
"""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from _env import REPO_ROOT, SUBPROC_ENV
from _torch_env import bits, to_torch, world1
from repro.compat import make_mesh, shard_map
from repro.configs import get_reduced as jax_get_reduced
from repro.core import bucketing as jax_bucketing
from repro.core.schedule import Schedule as JaxSchedule
from repro.core.sync import SyncConfig as JaxSyncConfig, make_gradient_sync as jax_make_sync
from repro.launch.specs import param_specs
from repro_torch.configs import get_reduced
from repro_torch.core import bucketing
from repro_torch.core.schedule import Schedule
from repro_torch.core.sync import SyncConfig, count_expected_allreduces, make_gradient_sync
from repro_torch.fabric.ops import issue
from repro_torch.kernels.comm_pack import pack_arena, reset_counts, unpack_arena
from repro_torch.models import from_jax_params, param_shapes

ARCH = "tinyllama-1.1b"
# embed+stage_0 | stages 1..3 | head+final_norm: a leaf+slice group, a
# multi-stage slice group and a leaf group
GROUPS = ((1, 2), (3, 5), (6, 6))
MODES = [("concat", None), ("concat", "bf16"), ("arena", None), ("arena", "bf16"),
         ("arena", "bf16_ef")]


def _cfgs(dtypes):
    jdt, tdt = (jnp.float32, torch.float32) if dtypes == "f32" else (jnp.bfloat16, torch.bfloat16)
    return jax_get_reduced(ARCH, param_dtype=jdt), get_reduced(ARCH, param_dtype=tdt)


def _grads(jcfg, seed, scale=1.0, f32=False):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: np.asarray(jnp.asarray(
            rng.standard_normal(s.shape).astype(np.float32) * scale,
            jnp.float32 if f32 else s.dtype,
        )),
        param_specs(jcfg),
    )


@pytest.mark.parametrize("fuse,comp", MODES, ids=[f"{f}-{c}" for f, c in MODES])
@pytest.mark.parametrize("dtypes", ["f32", "mixed"])
def test_world1_bit_identical_to_reference(dtypes, fuse, comp):
    jcfg, tcfg = _cfgs(dtypes)
    ef = comp == "bf16_ef"
    g = _grads(jcfg, 0)
    r = _grads(jcfg, 1, scale=1e-2, f32=True) if ef else None

    jlayout = jax_bucketing.stacked_lm_layout(param_specs(jcfg), jcfg.n_stages)
    jsync = jax_make_sync(jlayout, JaxSchedule(GROUPS, "manual"), ("data",),
                          JaxSyncConfig(fuse=fuse, compression=comp))
    mesh = make_mesh((1,), ("data",))
    n_in = 2 if ef else 1
    f = jax.jit(shard_map(
        lambda *a: jsync(*a), mesh=mesh, in_specs=(P(),) * n_in,
        out_specs=(P(),) * n_in if ef else P(), axis_names={"data"}, check_vma=False,
    ))
    out = f(g, r) if ef else f(g)
    jout, jres = (out if ef else (out, None))

    world1()
    tlayout = bucketing.stacked_lm_layout(param_shapes(tcfg), tcfg.n_stages)
    tsync = make_gradient_sync(tlayout, Schedule(GROUPS, "manual"),
                               SyncConfig(fuse=fuse, compression=comp))
    grads = {n: to_torch(a) for n, a in from_jax_params(g, tcfg).items()}
    res = {n: to_torch(a) for n, a in from_jax_params(r, tcfg).items()} if ef else None
    issue.calls = 0
    reset_counts()
    tsync(grads, res)
    assert issue.calls == len(GROUPS) == count_expected_allreduces(tsync.schedule)
    if fuse == "arena":
        assert pack_arena.ref_calls == unpack_arena.ref_calls == len(GROUPS)

    want = from_jax_params(jax.tree.map(np.asarray, jout), tcfg)
    for n, t in grads.items():
        assert t.dtype == to_torch(want[n]).dtype, n
        np.testing.assert_array_equal(bits(t), bits(want[n]), err_msg=n)
    if ef:
        want_r = from_jax_params(jax.tree.map(np.asarray, jres), tcfg)
        for n, t in res.items():
            np.testing.assert_array_equal(bits(t), bits(want_r[n]), err_msg=n)


def test_sync_options_that_do_not_exist_raise():
    _, tcfg = _cfgs("f32")
    layout = bucketing.stacked_lm_layout(param_shapes(tcfg), tcfg.n_stages)
    sched = Schedule(GROUPS, "manual")
    with pytest.raises(ValueError, match="unknown fuse mode"):
        make_gradient_sync(layout, sched, SyncConfig(fuse="scatter"))
    with pytest.raises(ValueError, match="requires fuse='arena'"):
        make_gradient_sync(layout, sched, SyncConfig(fuse="variadic", compression="bf16_ef"))
    with pytest.raises(ValueError, match="requires fuse='arena'"):
        make_gradient_sync(layout, sched, SyncConfig(fuse="concat", compression="bf16_ef"))
    world1()
    sync = make_gradient_sync(layout, sched, SyncConfig(fuse="arena", compression="bf16_ef"))
    with pytest.raises(ValueError, match="needs the residual"):
        sync.sync_group(0, {})


JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.configs import get_reduced
    from repro.core.bucketing import stacked_lm_layout
    from repro.core.schedule import Schedule
    from repro.core.sync import SyncConfig, make_gradient_sync
    from repro.launch.specs import param_specs

    out_dir = sys.argv[1]
    groups = tuple(tuple(g) for g in json.loads(sys.argv[2]))
    modes = json.loads(sys.argv[3])
    cfg = get_reduced("tinyllama-1.1b")  # bf16 stages, f32 embed
    specs = param_specs(cfg)
    layout = stacked_lm_layout(specs, cfg.n_stages)
    mesh = make_mesh((2,), ("data",))
    rng = np.random.default_rng(0)
    flat, treedef = jax.tree_util.tree_flatten_with_path(specs)
    names = ["/".join(k.key for k in p) for p, _ in flat]

    def draw(scale, f32):
        return [np.stack([np.asarray(jnp.asarray(
            rng.standard_normal(s.shape).astype(np.float32) * scale,
            jnp.float32 if f32 else s.dtype)) for _ in range(2)]) for _, s in flat]

    g = draw(1.0, False)
    r = draw(1e-2, True)
    store, meta = {}, {}

    def put(key, arr):
        arr = np.asarray(arr)
        meta[key] = arr.dtype.name
        store[key] = arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr

    for n, a, b in zip(names, g, r):
        for k in range(2):
            put(f"in/{k}/{n}", a[k])
            put(f"res/{k}/{n}", b[k])
    gt = jax.tree_util.tree_unflatten(treedef, g)
    rt = jax.tree_util.tree_unflatten(treedef, r)
    for fuse, comp in modes:
        sync = make_gradient_sync(layout, Schedule(groups, "manual"), ("data",),
                                  SyncConfig(fuse=fuse, compression=comp))
        ef = comp == "bf16_ef"

        def body(*a):
            local = [jax.tree.map(lambda x: x[0], t) for t in a]
            out = sync(*local)
            return jax.tree.map(lambda x: x[None], out)

        n_in = 2 if ef else 1
        spec = (P("data"),) * n_in
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=spec,
                              out_specs=spec if ef else P("data"),
                              axis_names={"data"}, check_vma=False))
        res = f(gt, rt) if ef else f(gt)
        outs = [res[0], res[1]] if ef else [res]
        for tag, tree in zip(("out", "resout"), outs):
            for (p, leaf) in jax.tree_util.tree_flatten_with_path(tree)[0]:
                n = "/".join(k.key for k in p)
                for k in range(2):
                    put(f"{tag}/{fuse}-{comp}/{k}/{n}", leaf[k])
    np.savez(os.path.join(out_dir, "ref.npz"), **store)
    with open(os.path.join(out_dir, "meta.json"), "w") as fh:
        json.dump(meta, fh)
""")

TORCH_SCRIPT = textwrap.dedent("""
    import datetime, json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.core.bucketing import stacked_lm_layout
    from repro_torch.core.schedule import Schedule
    from repro_torch.core.sync import SyncConfig, make_gradient_sync
    from repro_torch.fabric.ops import issue
    from repro_torch.models import from_jax_params, param_shapes

    rank, out_dir = int(sys.argv[1]), sys.argv[2]
    groups = tuple(tuple(g) for g in json.loads(sys.argv[3]))
    modes = json.loads(sys.argv[4])
    dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "pg"),
                            rank=rank, world_size=2, timeout=datetime.timedelta(seconds=60))
    cfg = get_reduced("tinyllama-1.1b")
    layout = stacked_lm_layout(param_shapes(cfg), cfg.n_stages)
    ref = np.load(os.path.join(out_dir, "ref.npz"))
    meta = json.load(open(os.path.join(out_dir, "meta.json")))

    def per_layer(prefix):
        # per-rank stacked arrays under ``prefix`` -> per-layer tensors
        tree, dtypes = {}, {}
        for key in meta:
            if key.startswith(prefix):
                path = key[len(prefix):]
                node = tree
                for part in path.split("/")[:-1]:
                    node = node.setdefault(part, {})
                node[path.split("/")[-1]] = ref[key]
                dtypes[path] = meta[key]
        out = {}
        for n, a in from_jax_params(tree, cfg).items():
            parts = n.split(".")
            path = "/".join([parts[0], *parts[2:]] if parts[0] == "stages" else parts)
            a = np.ascontiguousarray(a)
            if dtypes[path] == "bfloat16":
                out[n] = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                out[n] = torch.from_numpy(a.copy())
        return out

    result = {"issue_calls": {}, "mismatch": []}
    for fuse, comp in modes:
        tag = f"{fuse}-{comp}"
        sync = make_gradient_sync(layout, Schedule(groups, "manual"),
                                  SyncConfig(fuse=fuse, compression=comp))
        grads = per_layer(f"in/{rank}/")
        res = per_layer(f"res/{rank}/") if comp == "bf16_ef" else None
        issue.calls = 0
        sync(grads, res)
        result["issue_calls"][tag] = issue.calls
        checks = [("out", grads)] + ([("resout", res)] if res is not None else [])
        for kind, got in checks:
            want = per_layer(f"{kind}/{tag}/{rank}/")
            for n, t in got.items():
                a = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                b = want[n].view(torch.int16) if want[n].dtype == torch.bfloat16 else want[n]
                if t.dtype != want[n].dtype or not torch.equal(a, b):
                    result["mismatch"].append(f"{tag} {kind} {n}")
    dist.destroy_process_group()
    print(json.dumps(result))
""")


def test_world2_gloo_matches_reference_on_two_devices(tmp_path):
    modes = [list(m) for m in MODES]
    args = [json.dumps([list(g) for g in GROUPS]), json.dumps(modes)]
    ref = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp_path), *args],
        capture_output=True, text=True, timeout=300, env=SUBPROC_ENV, cwd=REPO_ROOT,
    )
    assert ref.returncode == 0, ref.stderr[-3000:]
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", TORCH_SCRIPT, str(rank), str(tmp_path), *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO_ROOT,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=180)
            assert p.returncode == 0, stderr[-3000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rec in outs:
        assert rec["mismatch"] == [], rec["mismatch"][:10]
        assert rec["issue_calls"] == {f"{f}-{c}": len(GROUPS) for f, c in MODES}
