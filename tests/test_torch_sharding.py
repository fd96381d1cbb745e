"""The port's sharding rules (``repro_torch.parallel``) against the JAX
package's, at production sizes with no devices: the JAX rules are built on
a stub mesh (``axis_names`` and ``devices`` are all they read), the port's
on a stub ``DeviceMesh`` (``mesh_dim_names`` and ``mesh``).  Every
parameter spec of all ten archs on both production meshes and every
``fsdp_data`` mode, ``batch_axes``, the decode cache specs, ``moe_groups_for``
and ``from_rules`` must be equal, spec for spec (a port spec is the JAX
``PartitionSpec`` as a tuple).  Then ``constrain``: the identity
off-context and on a plain tensor, and on a fake 2x4 world (in a process
of its own) the placements each role gives."""

import json
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _env import REPO_ROOT, SUBPROC_ENV
from repro.configs import ARCH_NAMES, get_config as jax_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.launch.specs import arch_config_for_shape as jax_arch_config_for_shape
from repro.launch.specs import batch_input_specs as jax_batch_input_specs
from repro.launch.specs import cache_specs as jax_cache_specs
from repro.launch.specs import decode_input_specs as jax_decode_input_specs
from repro.launch.specs import opt_state_specs as jax_opt_state_specs
from repro.launch.specs import moe_groups_for as jax_moe_groups_for
from repro.launch.specs import param_specs as jax_param_specs
from repro.optim import make_optimizer as jax_make_optimizer
from repro.parallel.context import from_rules as jax_from_rules
from repro.parallel.sharding import cache_pspecs as jax_cache_pspecs
from repro.parallel.sharding import param_pspecs as jax_param_pspecs
from repro.parallel.sharding import rules_for_arch as jax_rules_for_arch
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, applicable_shapes
from repro_torch.launch.specs import (arch_config_for_shape, batch_input_specs, cache_specs,
                                     decode_input_specs, moe_groups_for, opt_state_specs,
                                     param_specs)
from repro_torch.optim import make_optimizer
from repro_torch.parallel import context
from repro_torch.parallel.sharding import cache_pspecs, is_spec, param_pspecs, rules_for_arch

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
FSDP = (False, True, "experts_only")


def jax_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def port_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(mesh_dim_names=axes, mesh=np.empty(shape))


def rules_pair(arch, mesh, fsdp):
    return (jax_rules_for_arch(jax_config(arch), jax_mesh(mesh), fsdp_data=fsdp),
            rules_for_arch(get_config(arch), port_mesh(mesh), fsdp_data=fsdp))


def jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


def port_leaves(tree, path=()) -> dict:
    if isinstance(tree, torch.Tensor) or is_spec(tree):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {k: v for key, sub in items for k, v in port_leaves(sub, path + (str(key),)).items()}


@pytest.fixture(scope="module")
def shape_trees():
    return {arch: (jax_param_specs(jax_config(arch)), param_specs(get_config(arch)))
            for arch in ARCH_NAMES}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_pspecs_equal_the_jax_rules(shape_trees, arch, mesh):
    jshapes, tshapes = shape_trees[arch]
    for fsdp in FSDP:
        jrules, trules = rules_pair(arch, mesh, fsdp)
        assert (jrules.data_axes, jrules.model_axis, jrules.mesh_shape, jrules.reserve_model) == \
            (trules.data_axes, trules.model_axis, trules.mesh_shape, trules.reserve_model)
        want = jax_leaves(jax_param_pspecs(jshapes, jrules))
        got = port_leaves(param_pspecs(tshapes, trules))
        assert set(got) == set(want), (arch, mesh, fsdp)
        for path, spec in want.items():
            assert got[path] == tuple(spec), (arch, mesh, fsdp, path, got[path], spec)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_axes_equal(mesh):
    for arch in ("tinyllama-1.1b", "dbrx-132b", "mixtral-8x7b"):
        for fsdp in FSDP:
            jrules, trules = rules_pair(arch, mesh, fsdp)
            for batch in (256, 32, 128, 1):
                assert trules.batch_axes(batch) == jrules.batch_axes(batch), (arch, batch)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_pspecs_equal_where_the_trees_share_a_leaf(arch, mesh):
    compared = 0
    for shape in ("decode_32k", "long_500k"):
        if shape not in applicable_shapes(arch):
            continue
        B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
        jrules, trules = rules_pair(arch, mesh, True)
        jtree, ttree = jax_cache_specs(jax_config(arch), B, S), cache_specs(get_config(arch), B, S)
        want = jax_leaves(jax_cache_pspecs(jax_config(arch), jrules, jtree, B))
        got = port_leaves(cache_pspecs(get_config(arch), trules, ttree, B))
        jshape = {k: tuple(v.shape) for k, v in jax_leaves(jtree).items()}
        tshape = {k: tuple(v.shape) for k, v in port_leaves(ttree).items()}
        for path, spec in want.items():
            if path in got and jshape[path] == tshape.get(path):
                assert got[path] == tuple(spec), (arch, mesh, shape, path)
                compared += 1
    assert compared or arch in ("musicgen-large", "qwen2-vl-2b"), arch


def test_moe_groups_and_from_rules_equal():
    for arch in ARCH_NAMES:
        for mesh in MESHES:
            jrules, trules = rules_pair(arch, mesh, True)
            for name in applicable_shapes(arch):
                shape = SHAPES[name]
                assert vars(shape) == vars(JAX_SHAPES[name])
                seq = shape.seq_len if shape.kind != "decode" else 1
                assert moe_groups_for(trules, shape.global_batch, seq) == \
                    jax_moe_groups_for(jrules, shape.global_batch, seq), (arch, mesh, name)
                for prefer in ("fsdp", "tp", "seq_tp"):
                    want = vars(jax_from_rules(jrules, shape.global_batch, prefer=prefer))
                    got = vars(context.from_rules(trules, shape.global_batch, prefer=prefer))
                    assert got == want, (arch, mesh, name, prefer)


def test_constrain_is_the_identity_off_context_and_on_plain_tensors():
    x = torch.randn(8, 4, 16)
    assert context.current() is None
    assert context.constrain(x, {0: "batch", 2: "model"}) is x
    ctx = context.ActSharding(batch_axes=("data",), model_axis="model", data_size=2,
                              model_size=4, prefer="tp", data_axes=("data",), raw_data_size=2)
    with context.activation_sharding(ctx):
        assert context.tp_active() and context.tp_size() == 4
        assert context.constrain(x, {0: "batch", 2: "model"}) is x
    assert context.current() is None and not context.tp_active() and context.tp_size() == 1


CONSTRAIN_ROLES = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None  # any import of jax now raises
    import torch
    from repro_torch.launch.segments import fake_dtensor, fake_mesh, fake_world
    from repro_torch.parallel import context
    from repro_torch.parallel.sharding import to_placements
    cases = [  # (prefer, batch_axes, roles)
        ("fsdp", ("data",), {0: "batch", 2: "model"}),
        ("tp", ("data",), {0: "batch", 2: "model"}),
        ("seq_tp", ("data",), {1: "model"}),
        ("fsdp", ("data",), {1: "expert"}),
        ("fsdp", ("data",), {2: "data"}),
        ("fsdp", ("data", "model"), {0: "batch"}),
        ("tp", ("data",), {1: "model"}),  # 6 does not split 4 ways: left as it is
    ]
    out = {"cases": []}
    with fake_world(8):
        mesh = fake_mesh((2, 4), ("data", "model"))
        out["nested"] = str(to_placements((("data", "model"), None), mesh))
        try:
            to_placements((("model", "data"),), mesh)
            out["out_of_order"] = "accepted"
        except ValueError:
            out["out_of_order"] = "refused"
        for prefer, ba, roles in cases:
            size = 8 if ba == ("data", "model") else 2
            ctx = context.ActSharding(
                batch_axes=ba, model_axis=None if "model" in ba else "model", data_size=size,
                model_size=4, prefer=prefer, data_axes=("data",), raw_data_size=2)
            x = fake_dtensor((8, 6 if roles == {1: "model"} and prefer == "tp" else 16, 32),
                             torch.float32, (None, None, None), mesh)
            with context.activation_sharding(ctx):
                y = context.constrain(x, roles)
            out["cases"].append([str(y.placements), y is x])
    print(json.dumps(out))
""")


def test_constrain_places_each_role_on_a_fake_world():
    """Each role's placements over (data, model) on a fake 2x4 world, in a
    process of its own (a fake world cannot start where a process group
    exists)."""
    proc = subprocess.run([sys.executable, "-c", CONSTRAIN_ROLES], capture_output=True,
                          text=True, timeout=300, cwd=REPO_ROOT, env=SUBPROC_ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["nested"] == "(Shard(dim=0), Shard(dim=0))"
    assert rec["out_of_order"] == "refused"
    assert rec["cases"] == [
        ["(Shard(dim=0), Replicate())", False],
        ["(Shard(dim=0), Shard(dim=2))", False],
        ["(Replicate(), Shard(dim=1))", False],
        ["(Replicate(), Shard(dim=1))", False],
        ["(Shard(dim=2), Replicate())", False],
        ["(Shard(dim=0), Shard(dim=0))", False],
        ["(Replicate(), Replicate())", True],
    ]


def _shape_dtype(leaves: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in leaves.items()}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b", "qwen2-vl-2b"])
def test_specs_match_the_jax_stand_ins(arch):
    """``opt_state_specs`` (AdamW: f32 m / v like the parameters, an int32
    step), the batch and decode inputs (token ids, or the embeds archs'
    bf16 embeddings; the port's ids index as int32 does), and
    ``arch_config_for_shape``'s knobs, shape for shape."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jst = jax_opt_state_specs(jcfg, jax_make_optimizer("adamw"))
    tst = opt_state_specs(tcfg, make_optimizer("adamw"))
    assert _shape_dtype(port_leaves(tst.m)) == _shape_dtype(jax_leaves(jst.m))
    assert _shape_dtype(port_leaves(tst.v)) == _shape_dtype(jax_leaves(jst.v))
    assert (tuple(tst.step.shape), tst.step.dtype) == ((), torch.int32) and \
        str(jst.step.dtype) == "int32"
    for name in applicable_shapes(arch):
        for jfn, tfn in ((jax_batch_input_specs, batch_input_specs),
                         (jax_decode_input_specs, decode_input_specs)):
            want, got = jfn(jcfg, JAX_SHAPES[name]), tfn(tcfg, SHAPES[name])
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}, (name, jfn.__name__)
        jc, tc = jax_arch_config_for_shape(arch, name), arch_config_for_shape(arch, name)
        assert (tc.q_chunk, tc.rec_chunk, tc.remat) == (jc.q_chunk, jc.rec_chunk, jc.remat)
        assert tc.attn_impl == "plain"
        assert arch_config_for_shape(arch, name, cost_mode=True).remat == "none"
