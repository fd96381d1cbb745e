"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's ``repro.checkpoint``, on the CPU.

* Tensors round-trip bit for bit: bf16 (stored as its 16-bit pattern),
  f32, f64, int64, int32, int8, bool, and numbers beside them.
* A ``.tmp`` directory (a write killed mid-flight) is never listed, by
  either package's ``available_steps``; a second save of a step replaces
  it; a shape or dtype mismatch raises ``ValueError`` before anything is
  written into the live tensors.
* ``AsyncCheckpointer.save`` copies the tensors before it returns: every
  tensor changed in place right after ``save`` (while the write is held
  back) reads back with its values from before the change.
* ``plan.json`` and ``tuner.json`` written by the port load in the JAX
  package (``Plan.from_json``, ``Tuner.load_state``) to the same JSON
  dicts, and the reverse; ``restore_rebucketed`` returns the new schedule.

Everything here is exact: no tolerance.
"""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_env import bits
from _torch_registry import pristine_policy_registries  # noqa: F401  (autouse)
from repro import checkpoint as jax_ckpt
from repro.configs import get_reduced as jax_get_reduced
from repro.core import bucketing as jax_bucketing
from repro.core.trainer import lm_unit_costs as jax_lm_unit_costs
from repro.fabric import get_fabric as jax_get_fabric
from repro.launch.specs import param_specs
from repro.planning import Plan as JaxPlan, Tuner as JaxTuner, build_plan as jax_build_plan
from repro.planning import MeasuredCosts as JaxMeasuredCosts
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import checkpoint as ckpt_module
from repro_torch.configs import get_reduced
from repro_torch.core import bucketing
from repro_torch.core.trainer import lm_unit_costs
from repro_torch.fabric import get_fabric
from repro_torch.models import param_shapes
from repro_torch.planning import MeasuredCosts, Plan, Tuner, build_plan

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64,
          "int64": torch.int64, "int32": torch.int32, "int8": torch.int8, "bool": torch.bool}


def _tensor(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) < 0.5)
    if dtype.is_floating_point:
        # subnormals, infinities and NaN too: the bits must come back
        x = torch.from_numpy(rng.standard_normal(shape) * 10.0 ** rng.integers(-40, 40, shape))
        x = x.to(dtype)
        flat = x.reshape(-1)
        flat[:3] = torch.tensor([float("inf"), float("-inf"), float("nan")], dtype=dtype)
        return x
    info = torch.iinfo(dtype)
    return torch.from_numpy(rng.integers(info.min, info.max, shape, endpoint=True)).to(dtype)


def _tree(seed=0):
    return {
        "params": {f"p.{name}": _tensor(dt, (3, 5, 7), seed + i)
                   for i, (name, dt) in enumerate(DTYPES.items())},
        "opt_state": {"step": 11, "m": {"p.f32": _tensor(torch.float32, (3, 5, 7), 99)},
                      "v": {}},
        "scalar": 2.5,
    }


def _like(tree):
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return type(tree)(0)


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_same(got[k], w)
        elif isinstance(w, torch.Tensor):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            assert np.array_equal(bits(got[k]), bits(w)), k
        else:
            assert type(got[k]) is type(w) and got[k] == w, k


@pytest.mark.parametrize("name", list(DTYPES))
def test_tensors_round_trip_bitwise(name, tmp_path):
    """Each dtype alone: the same bits into a live tensor, in place; the
    manifest records the dtype by name and the shape."""
    x = _tensor(DTYPES[name], (4, 9), 1)
    ckpt.save(tmp_path, 1, {"params": {"x": x}})
    live = torch.zeros_like(x)
    tree, extra = ckpt.restore(tmp_path, 1, {"params": {"x": live}})
    assert tree["params"]["x"] is live and extra == {}
    assert np.array_equal(bits(live), bits(x))
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    (entry,) = manifest["entries"]
    want = "bfloat16" if name == "bf16" else str(DTYPES[name]).removeprefix("torch.")
    assert entry["name"] == "params/x" and entry["dtype"] == want and entry["shape"] == [4, 9]


def test_nested_tree_and_numbers_round_trip(tmp_path):
    tree = _tree()
    path = ckpt.save(tmp_path, 7, tree, extra={"restarts": 2})
    assert path == tmp_path / "step_00000007"
    like = _like(tree)
    got, extra = ckpt.restore(tmp_path, 7, like)
    _assert_same(got, tree)
    _assert_same(like, {**tree, "opt_state": {**tree["opt_state"], "step": 0}, "scalar": 0.0})
    assert extra == {"restarts": 2}


def test_tmp_directories_are_ignored_by_both_packages(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 2, tree)
    ckpt.save(tmp_path, 5, tree)
    (tmp_path / "step_00000009.tmp").mkdir()  # a write killed mid-flight
    (tmp_path / "step_00000009.tmp" / "manifest.json").write_text("{}")
    (tmp_path / "step_00000012").mkdir()  # renamed, but no manifest
    assert ckpt.available_steps(tmp_path) == jax_ckpt.available_steps(tmp_path) == [2, 5]
    assert ckpt.latest_step(tmp_path) == jax_ckpt.latest_step(tmp_path) == 5
    assert ckpt.latest_step(tmp_path / "missing") is None


def test_overwriting_a_step_replaces_it(tmp_path):
    ckpt.save(tmp_path, 3, _tree(0), extra={"k": 1})
    (tmp_path / "step_00000003" / "stale.txt").write_text("from the first save")
    second = _tree(50)
    ckpt.save(tmp_path, 3, second, extra={"k": 2})
    assert not (tmp_path / "step_00000003" / "stale.txt").exists()
    got, extra = ckpt.restore(tmp_path, 3, _like(second))
    _assert_same(got, second)
    assert extra == {"k": 2} and ckpt.available_steps(tmp_path) == [3]


@pytest.mark.parametrize("change", ["shape", "dtype", "missing"])
def test_mismatch_raises_before_writing(change, tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 1, tree)
    like = _like(tree)
    for t in like["params"].values():
        t.fill_(1)
    if change == "shape":
        like["params"]["p.f64"] = torch.ones(3, 5, 8, dtype=torch.float64)
        match = r"checkpoint shape \(3, 5, 7\) != expected \(3, 5, 8\)"
    elif change == "dtype":
        like["params"]["p.f64"] = torch.ones(3, 5, 7, dtype=torch.float32)
        match = "dtype float64 != expected float32"
    else:
        like["params"]["p.new"] = torch.ones(2)
        match = "no entry 'params/p.new'"
    with pytest.raises(ValueError, match=match):
        ckpt.restore(tmp_path, 1, like)
    for t in like["params"].values():  # nothing was written
        assert bool((t == 1).all())


def test_async_save_does_not_alias_live_tensors(tmp_path, monkeypatch):
    """The background write is held back until every tensor has been
    changed in place; the file still holds the values ``save`` saw."""
    release = threading.Event()
    real_save = ckpt_module.save

    def held_save(*args, **kwargs):
        assert release.wait(timeout=60)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(ckpt_module, "save", held_save)
    tree = _tree()
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in tree["params"].items()}
    writer = ckpt.AsyncCheckpointer(tmp_path)
    writer.save(4, tree, extra={"restarts": 0})
    for t in tree["params"].values():
        t.logical_not_() if t.dtype == torch.bool else t.add_(1)
    tree["opt_state"]["m"]["p.f32"].mul_(3)
    release.set()
    writer.wait()
    (rec,) = writer.records
    assert rec["step"] == 4 and rec["op"] == "save" and rec["write_s"] >= 0
    assert rec["bytes"] == sum(t.nbytes for t in want.values()) + 3 * 5 * 7 * 4
    got, _ = ckpt.restore(tmp_path, 4, _like(_tree()))
    _assert_same(got["params"], want)
    _assert_same(got["opt_state"]["m"], _tree()["opt_state"]["m"])


def test_async_errors_surface_on_wait(tmp_path):
    writer = ckpt.AsyncCheckpointer(tmp_path)
    writer.save(1, {"params": {"x": torch.zeros(2)}}, extra={"bad": object()})
    with pytest.raises(TypeError, match="not JSON serializable"):
        writer.wait()
    writer.wait()  # raised once
    assert ckpt.available_steps(tmp_path) == []


def _plans_and_tuners():
    arch = "tinyllama-1.1b"
    jcfg, tcfg = jax_get_reduced(arch), get_reduced(arch)
    jshapes, tshapes = param_specs(jcfg), param_shapes(tcfg)
    jlay = jax_bucketing.stacked_lm_layout(jshapes, jcfg.n_stages)
    tlay = bucketing.stacked_lm_layout(tshapes, tcfg.n_stages)
    jcosts = jax_lm_unit_costs(jcfg, jshapes, 1024)
    tcosts = lm_unit_costs(tcfg, tshapes, 1024)
    jar = jax_get_fabric("gpu_nccl").cost("all_reduce", {"data": 8})
    tar = get_fabric("gpu_nccl").cost("all_reduce", {"data": 8})
    jplan = jax_build_plan(jlay, jcosts, jar, policy="mg_wfbp", n_scan_stages=jcfg.n_stages)
    tplan = build_plan(tlay, tcosts, tar, policy="mg_wfbp", n_scan_stages=tcfg.n_stages)
    jt = JaxTuner(layout=jlay, n_scan_stages=jcfg.n_stages, shapes=jshapes)
    tt = Tuner(layout=tlay, n_scan_stages=tcfg.n_stages, shapes=tshapes)
    secs = list(np.exp(np.random.default_rng(3).uniform(np.log(1e-5), np.log(1e-2),
                                                         len(tcosts))))
    jm = JaxMeasuredCosts.from_unit_times(jcosts, secs)
    tm = MeasuredCosts.from_unit_times(tcosts, secs)
    jt.sweep(jm.layer_costs(), jar, jm.hw, trigger="startup")
    tt.sweep(tm.layer_costs(), tar, tm.hw, trigger="startup")
    jt.observe(0.0125)
    tt.observe(0.0125)
    return jlay, tlay, jplan, tplan, jt, tt


def test_plan_and_tuner_files_load_across_packages(tmp_path):
    jlay, tlay, jplan, tplan, jt, tt = _plans_and_tuners()
    state = dict(tt.state_dict(), comm_refitter={"checks": 3})
    # written by the port, read by the JAX package
    ckpt.save(tmp_path / "port", 6, {"params": {"x": torch.ones(2)}}, plan=tplan, tuner=state)
    assert jax_ckpt.latest_step(tmp_path / "port") == 6
    jax_plan = jax_ckpt.load_plan(tmp_path / "port", 6)
    assert isinstance(jax_plan, JaxPlan)
    assert jax_plan.to_json_dict() == tplan.to_json_dict() == jplan.to_json_dict()
    jax_state = jax_ckpt.load_tuner_state(tmp_path / "port", 6)
    assert jax_state == json.loads(json.dumps(state))
    assert JaxTuner(layout=jlay).load_state(jax_state).state_dict() == jt.state_dict()
    # written by the JAX package, read by the port
    jax_ckpt.save(tmp_path / "jax", 8, {"x": jnp.ones(2)}, plan=jplan, tuner=jt)
    assert ckpt.latest_step(tmp_path / "jax") == 8
    port_plan = ckpt.load_plan(tmp_path / "jax", 8)
    assert isinstance(port_plan, Plan) and port_plan.to_json_dict() == jplan.to_json_dict()
    port_state = ckpt.load_tuner_state(tmp_path / "jax", 8)
    assert port_state == json.loads(json.dumps(jt.state_dict()))
    assert Tuner(layout=tlay).load_state(port_state).state_dict() == tt.state_dict()
    # no plan or tuner stored: None from both
    ckpt.save(tmp_path / "bare", 1, {"params": {"x": torch.ones(2)}})
    assert ckpt.load_plan(tmp_path / "bare", 1) is jax_ckpt.load_plan(tmp_path / "bare", 1) is None
    assert ckpt.load_tuner_state(tmp_path / "bare", 1) is None


def test_restore_rebucketed_returns_the_new_schedule(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 2, tree, extra={"world": 2})
    like = _like(tree)
    got, schedule, extra = ckpt.restore_rebucketed(tmp_path, 2, like, lambda: "replanned")
    _assert_same(got, tree)
    assert schedule == "replanned" and extra == {"world": 2}
