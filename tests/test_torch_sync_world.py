"""Sync parity at world 4 and world 8: the port's ``make_gradient_sync`` on
gloo ranks (one process each) against the JAX package's on 8 virtual CPU
devices (one subprocess; world 4 on the first four), for ``concat`` /
``variadic`` / ``arena`` x None / ``bf16``, and ``arena`` x ``bf16_ef``.

Reduced TinyLlama at its own dtypes (bf16 stages, f32 embed), the groups
of ``tests/test_torch_sync.py`` (a leaf + slice group, a multi-stage slice
group and a leaf group).  Every rank's gradient element is k/16 with
1 <= |k| <= 15, so any sum of 8 is exact in f32 and in bf16, and the 1/4
and 1/8 averages are exact: the reduced gradients must be bitwise the
reference's whatever order gloo and XLA add in.  The ``bf16_ef`` residual
is drawn below half a bf16 step of the smallest gradient (|r| < 2^-13),
so the wire still carries k/16 while the new residual is nonzero: the
residuals are each rank's own arithmetic and must be bitwise too.
``issue.calls`` rises by exactly one per group on every rank, for the
coalesced ``variadic`` call as for the others.
"""

import json
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from _env import REPO_ROOT, SUBPROC_ENV
from repro.configs import get_reduced as jax_get_reduced
from repro.launch.specs import param_specs

GROUPS = ((1, 2), (3, 5), (6, 6))
MODES = [("concat", None), ("concat", "bf16"), ("variadic", None), ("variadic", "bf16"),
         ("arena", None), ("arena", "bf16"), ("arena", "bf16_ef")]
WORLDS = (4, 8)
TAGS = [f"{f}-{c}" for f, c in MODES]

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.configs import get_reduced
    from repro.core.bucketing import stacked_lm_layout
    from repro.core.schedule import Schedule
    from repro.core.sync import SyncConfig, make_gradient_sync
    from repro.launch.specs import param_specs

    d, groups, modes = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
    groups = tuple(tuple(g) for g in groups)
    cfg = get_reduced("tinyllama-1.1b")
    specs = param_specs(cfg)
    layout = stacked_lm_layout(specs, cfg.n_stages)
    flat, treedef = jax.tree_util.tree_flatten_with_path(specs)
    names = ["/".join(k.key for k in p) for p, _ in flat]
    inputs = np.load(os.path.join(d, "inputs.npz"))
    out = {}
    for world in (4, 8):
        mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
        g = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(inputs[f"w{world}/g/{n}"], s.dtype) for n, (_, s) in zip(names, flat)])
        r = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(inputs[f"w{world}/r/{n}"]) for n in names])
        for fuse, comp in modes:
            sync = make_gradient_sync(layout, Schedule(groups, "manual"), ("data",),
                                      SyncConfig(fuse=fuse, compression=comp))
            ef = comp == "bf16_ef"

            def body(*a):
                local = [jax.tree.map(lambda x: x[0], t) for t in a]
                return jax.tree.map(lambda x: x[None], sync(*local))

            spec = (P("data"),) * (2 if ef else 1)
            f = jax.jit(shard_map(body, mesh=mesh, in_specs=spec,
                                  out_specs=spec if ef else P("data"),
                                  axis_names={"data"}, check_vma=False))
            res = f(g, r) if ef else f(g)
            trees = [("out", res[0]), ("res", res[1])] if ef else [("out", res)]
            for kind, tree in trees:
                for (p, leaf) in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    n = "/".join(k.key for k in p)
                    out[f"w{world}/{fuse}-{comp}/{kind}/{n}"] = np.asarray(leaf, np.float32)
                    out[f"w{world}/{fuse}-{comp}/dtype/{n}"] = np.array(str(leaf.dtype))
    np.savez(os.path.join(d, "jax.npz"), **out)
    print(json.dumps({"ok": True}))
""")

RANK_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch, torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.core.bucketing import stacked_lm_layout
    from repro_torch.core.schedule import Schedule
    from repro_torch.core.sync import SyncConfig, count_expected_allreduces, make_gradient_sync
    from repro_torch.fabric.ops import issue
    from repro_torch.models import Transformer, from_jax_params, param_shapes

    rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    groups = tuple(tuple(g) for g in json.loads(sys.argv[5]))
    modes = json.loads(sys.argv[6])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    cfg = get_reduced("tinyllama-1.1b")
    layout = stacked_lm_layout(param_shapes(cfg), cfg.n_stages)
    inputs = np.load(os.path.join(d, "inputs.npz"))

    def tree_of(prefix):
        tree = {}
        for key in inputs.files:
            if key.startswith(prefix):
                parts = key[len(prefix):].split("/")
                node = tree
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = inputs[key][rank]
        return from_jax_params(tree, cfg)

    def path(name):  # per-layer name -> (stacked path, stage or None)
        parts = name.split(".")
        if parts[0] == "stages":
            return "/".join(["stages", *parts[2:]]), int(parts[1])
        return "/".join(parts), None

    dtypes = {n: p.dtype for n, p in Transformer(cfg, device="meta", seed=None).named_parameters()}
    g_np, r_np = tree_of(f"w{world}/g/"), tree_of(f"w{world}/r/")
    result = {"calls": {}, "expected": {}}
    store = {}
    for fuse, comp in modes:
        tag = f"{fuse}-{comp}"
        cfg_sync = SyncConfig(fuse=fuse, compression=comp)
        sync = make_gradient_sync(layout, Schedule(groups, "manual"), cfg_sync)
        grads = {n: torch.from_numpy(a.copy()).to(dtypes[n]) for n, a in g_np.items()}
        res = ({n: torch.from_numpy(a.copy()) for n, a in r_np.items()}
               if comp == "bf16_ef" else None)
        before = issue.calls
        sync(grads, res)
        result["calls"][tag] = issue.calls - before
        result["expected"][tag] = count_expected_allreduces(sync.schedule, cfg_sync)
        for kind, tree in [("out", grads)] + ([("res", res)] if res is not None else []):
            for name, t in tree.items():
                p, stage = path(name)
                store[f"{tag}/{kind}/{p}/{stage}"] = t.float().numpy()
                store[f"{tag}/dtype/{p}/{stage}"] = np.array(str(t.dtype).split(".")[-1])
    np.savez(os.path.join(d, f"torch_w{world}_r{rank}.npz"), **store)
    dist.destroy_process_group()
    print(json.dumps(result))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Inputs from one numpy seed; the JAX sync at world 4 and 8 in one
    subprocess and the port's on 4 + 8 gloo ranks, all side by side."""
    d = tmp_path_factory.mktemp("sync_world")
    specs = param_specs(jax_get_reduced("tinyllama-1.1b"))
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    rng = np.random.default_rng(7)
    inputs = {}
    for world in WORLDS:
        for p, s in flat:
            n = "/".join(k.key for k in p)
            k = rng.integers(1, 16, (world, *s.shape)) * rng.choice([-1, 1], (world, *s.shape))
            inputs[f"w{world}/g/{n}"] = (k / 16.0).astype(np.float32)
            inputs[f"w{world}/r/{n}"] = rng.uniform(-2.0**-13, 2.0**-13,
                                                    (world, *s.shape)).astype(np.float32)
    np.savez(d / "inputs.npz", **inputs)
    args = [json.dumps([list(g) for g in GROUPS]), json.dumps([list(m) for m in MODES])]
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(d), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO_ROOT)]
    for world in WORLDS:
        port = _free_port()
        procs += [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(world),
                                    str(port), str(d), *args],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                   env=env, cwd=REPO_ROOT)
                  for r in range(world)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-3000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = {4: outs[1:5], 8: outs[5:]}
    return d, ranks


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("world", WORLDS)
def test_sync_matches_reference_on_gloo_ranks(world, tag, worlds):
    d, ranks = worlds
    ref = np.load(d / "jax.npz")
    inputs = np.load(d / "inputs.npz")
    for rank, rec in enumerate(ranks[world]):
        assert rec["calls"][tag] == rec["expected"][tag] == len(GROUPS)
        got = np.load(d / f"torch_w{world}_r{rank}.npz")
        kinds = ("out", "res") if tag.endswith("bf16_ef") else ("out",)
        checked = 0
        for key in got.files:
            tag_, kind, rest = key.split("/", 2)
            if tag_ != tag or kind not in kinds:
                continue
            p, stage = rest.rsplit("/", 1)
            want = ref[f"w{world}/{tag}/{kind}/{p}"][rank]
            want_dtype = str(ref[f"w{world}/{tag}/dtype/{p}"])
            if stage != "None":
                want = want[int(stage)]
            assert str(got[f"{tag}/dtype/{p}/{stage}"]) == want_dtype, key
            assert got[key].shape == want.shape, key
            assert np.array_equal(got[key].view(np.uint32), want.view(np.uint32)), key
            checked += 1
        assert checked >= 10
        if tag.endswith("bf16_ef"):  # the residual moved: nonzero and not the input
            res = got[f"{tag}/res/stages/attn_0/attn/wq/0"]
            assert np.abs(res).max() > 0
            assert not np.array_equal(res, inputs[f"w{world}/r/stages/attn_0/attn/wq"][rank][0])
