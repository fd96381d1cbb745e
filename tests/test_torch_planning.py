"""Planning and bucketing parity: the port's copies of the planning math
against the JAX package, on tinyllama's unit costs (reduced and full).

Every registered policy must give the same groups and the same float
``t_iter``; the wire plan and every arena offset and size must be equal;
a Plan JSON written by either package must load in the other.  Exact
equality throughout: the planning math is the same Python on the same
floats.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config, get_reduced as jax_get_reduced
from repro.core import bucketing as jax_bucketing
from repro.core.trainer import lm_unit_costs as jax_lm_unit_costs
from repro.fabric import available_fabrics as jax_fabrics, get_fabric as jax_get_fabric
from repro.launch.specs import param_specs
from repro.planning import (
    Plan as JaxPlan,
    available_policies as jax_policies,
    build_plan as jax_build_plan,
    build_schedule as jax_build_schedule,
)
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import bucketing
from repro_torch.core.trainer import lm_unit_costs
from repro_torch.fabric import available_fabrics, get_fabric
from repro_torch.models import Transformer, param_shapes
from repro_torch.planning import Plan, available_policies, build_plan, build_schedule

ARCH = "tinyllama-1.1b"
TOKENS = 2048


def _cfgs(size):
    if size == "reduced":
        return jax_get_reduced(ARCH), get_reduced(ARCH)
    return jax_get_config(ARCH), get_config(ARCH)


def _setup(size, fabric="gpu_nccl"):
    jcfg, tcfg = _cfgs(size)
    jshapes, tshapes = param_specs(jcfg), param_shapes(tcfg)
    jcosts = jax_lm_unit_costs(jcfg, jshapes, TOKENS)
    tcosts = lm_unit_costs(tcfg, tshapes, TOKENS)
    jar = jax_get_fabric(fabric).cost("all_reduce", {"data": 32})
    tar = get_fabric(fabric).cost("all_reduce", {"data": 32})
    return jcfg, tcfg, jshapes, tshapes, jcosts, tcosts, jar, tar


def test_registries_match():
    assert available_policies() == jax_policies()
    assert available_fabrics() == jax_fabrics()


@pytest.mark.parametrize("fabric", ["gpu_nccl", "tpu_v5e", "paper_10gbe", "tree_10gbe"])
def test_fabric_costs_match(fabric):
    for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all"):
        for axes in ({"data": 8}, {"data": 32}, {"model": 4}):
            assert dataclasses.asdict(get_fabric(fabric).cost(op, axes)) == dataclasses.asdict(
                jax_get_fabric(fabric).cost(op, axes)
            )


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_shape_tree_and_unit_costs_match(size):
    jcfg, tcfg, jshapes, tshapes, jcosts, tcosts, _, _ = _setup(size)
    jleaves = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tleaves = bucketing._subtree_paths(tshapes, ())
    assert [jax_bucketing.normalize_path(tuple(p)) for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(j.shape) == tuple(t.shape)
        assert jnp.dtype(j.dtype).name == bucketing.dtype_name(t.dtype)
    assert [dataclasses.asdict(c) for c in tcosts] == [dataclasses.asdict(c) for c in jcosts]


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("policy", ["wfbp", "synceasgd", "fixed", "mg_wfbp", "dp_optimal", "optimal"])
def test_policies_give_same_schedule(size, policy):
    _, _, _, _, jcosts, tcosts, jar, tar = _setup(size)
    try:
        jsched = jax_build_schedule(policy, jcosts, jar)
    except ValueError as e:  # 'optimal' refuses 24 units, in both packages
        with pytest.raises(ValueError, match=str(e)[:20]):
            build_schedule(policy, tcosts, tar)
        return
    tsched = build_schedule(policy, tcosts, tar)
    assert tsched.groups == jsched.groups
    assert tsched.method == jsched.method
    assert tsched.result.t_iter == jsched.result.t_iter  # exact float
    assert tsched.result.t_comm_exposed == jsched.result.t_comm_exposed


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("policy", ["wfbp", "mg_wfbp", "synceasgd", "fixed"])
def test_wire_entries_and_arenas_match(size, policy):
    jcfg, tcfg, jshapes, tshapes, jcosts, tcosts, jar, tar = _setup(size)
    jlayout = jax_bucketing.stacked_lm_layout(jshapes, jcfg.n_stages)
    tlayout = bucketing.stacked_lm_layout(tshapes, tcfg.n_stages)
    assert [dataclasses.asdict(u) for u in tlayout.units] == [
        dataclasses.asdict(u) for u in jlayout.units
    ]
    jsched = jax_build_schedule(policy, jcosts, jar)
    tsched = build_schedule(policy, tcosts, tar)
    assert bucketing.wire_entries(tlayout, tsched) == jax_bucketing.wire_entries(jlayout, jsched)
    for wire in ("float32", "bfloat16"):
        ja = jax_bucketing.group_arenas(jlayout, jsched, jshapes, wire)
        ta = bucketing.group_arenas(tlayout, tsched, tshapes, wire)
        assert len(ta) == len(ja)
        for t, j in zip(ta, ja):
            assert (t.size, t.nbytes, t.comm_dtype) == (j.size, j.nbytes, j.comm_dtype)
            assert [(s.kind, s.path, s.stack_range, s.offset, s.size, s.shape) for s in t.slots] == [
                (s.kind, s.path, s.stack_range, s.offset, s.size, s.shape) for s in j.slots
            ]


@pytest.mark.parametrize("policy", ["wfbp", "mg_wfbp", "synceasgd"])
def test_entry_names_cover_the_model_once(policy):
    _, tcfg, _, tshapes, _, tcosts, _, tar = _setup("reduced")
    layout = bucketing.stacked_lm_layout(tshapes, tcfg.n_stages)
    sched = build_schedule(policy, tcosts, tar)
    names = [n for g in bucketing.wire_entries(layout, sched) for e in g
             for n in bucketing.entry_param_names(e)]
    model = Transformer(tcfg, device="meta", seed=None)
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    assert len(names) == len(set(names))
    # a slice entry's parts, in order, are exactly the stacked leaf[a:b]
    params = dict(model.named_parameters())
    arenas = bucketing.group_arenas(layout, sched, tshapes)
    for entries, arena in zip(bucketing.wire_entries(layout, sched), arenas):
        for e, slot in zip(entries, arena.slots):
            assert sum(params[n].numel() for n in bucketing.entry_param_names(e)) == slot.size


def _plans(size):
    jcfg, tcfg, jshapes, tshapes, jcosts, tcosts, jar, tar = _setup(size)
    jplan = jax_build_plan(
        jax_bucketing.stacked_lm_layout(jshapes, jcfg.n_stages), jcosts, jar,
        n_scan_stages=jcfg.n_stages, provenance={"arch": jcfg.name},
    )
    tplan = build_plan(
        bucketing.stacked_lm_layout(tshapes, tcfg.n_stages), tcosts, tar,
        n_scan_stages=tcfg.n_stages, provenance={"arch": tcfg.name},
    )
    return jplan, tplan


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_plan_json_round_trips_across_packages(size, tmp_path):
    jplan, tplan = _plans(size)
    assert json.loads(tplan.to_json()) == json.loads(jplan.to_json())
    tplan.save(tmp_path / "t.json")
    jplan.save(tmp_path / "j.json")
    from_port = JaxPlan.load(tmp_path / "t.json")
    from_ref = Plan.load(tmp_path / "j.json")
    assert from_port.to_json_dict() == jplan.to_json_dict()
    assert from_ref.to_json_dict() == tplan.to_json_dict()
    assert from_ref.segments == jplan.segments
    assert from_ref.group_arenas(param_shapes(_cfgs(size)[1]))[0].size == \
        jplan.group_arenas(param_specs(_cfgs(size)[0]))[0].size


def test_other_archs_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("musicgen-large")
    with pytest.raises(KeyError):
        get_reduced("no-such-arch")


def test_param_shapes_are_meta():
    shapes = param_shapes(get_config(ARCH))
    assert shapes["embed"].device.type == "meta"
    assert shapes["embed"].dtype == torch.float32
    assert shapes["head"].dtype == torch.bfloat16
    assert bucketing.tree_size(shapes) == 1_100_048_384
    assert np.prod(shapes["stages"]["attn_0"]["attn"]["wq"].shape) == 22 * 2048 * 2048
