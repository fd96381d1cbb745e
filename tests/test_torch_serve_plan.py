"""ServePlan parity: the port's ``planning.serve`` against the JAX
package's on the same configs.

For every ported arch, under ``gpu_nccl``, ``tpu_v5e`` and ``paper_10gbe``
over ``{"model": 8}``: the same decode cost vector, identical plan JSON,
each package reading the other's (and writing it back unchanged), and the
floats within 1e-12 relative (they are the same Python on the same
floats, so in practice equal).  Re-planning at a new (α, β), the slim
re-fit, the calibrated fixed term and the printed tables match too; the
functions that need a tensor-parallel group raise without one (they run
on gloo ranks in ``tests/test_torch_sharded_serving.py``).
"""

import json

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.comm_model import AllReduceModel as JaxAllReduceModel
from repro.launch.specs import param_specs
from repro.planning import ServePlan as JaxServePlan
from repro.planning import build_serve_plan as jax_build_serve_plan
from repro.planning import decode_unit_costs as jax_decode_unit_costs
from repro.planning import group_comparison_lines as jax_group_comparison_lines
from repro.planning.serve import rebuild_serve_plan as jax_rebuild_serve_plan
from repro.planning.serve import refit_serve_fit as jax_refit_serve_fit
from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.core.comm_model import AllReduceModel
from repro_torch.models import param_shapes
from repro_torch.planning import (
    ServePlan,
    build_serve_plan,
    decode_unit_costs,
    group_comparison_lines,
    make_group_collective,
    measure_serve_comm,
    rebuild_serve_plan,
    refit_serve_fit,
    serve_collective_time_fn,
    serve_fabric_fits,
    time_serve_groups,
)

FABRICS = ("gpu_nccl", "tpu_v5e", "paper_10gbe")
AXES = {"model": 8}
REL = 1e-12


def _close_tree(a, b):
    """Equal JSON trees, floats to ``REL``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _close_tree(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _close_tree(x, y)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=REL, abs=0.0)
    else:
        assert a == b


def _plans(arch, fabric, **kw):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jplan = jax_build_serve_plan(jcfg, param_specs(jcfg), fabric, AXES, batch_rows=4, **kw)
    tplan = build_serve_plan(tcfg, param_shapes(tcfg), fabric, AXES, batch_rows=4, **kw)
    return jplan, tplan


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_serve_plan_json_matches_reference(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jcosts = jax_decode_unit_costs(jcfg, param_specs(jcfg), 4, cache_dtype_bytes=4)
    tcosts = decode_unit_costs(tcfg, param_shapes(tcfg), 4, cache_dtype_bytes=4)
    assert [c.__dict__ for c in tcosts] == [c.__dict__ for c in jcosts]
    for fabric in FABRICS:
        jplan, tplan = _plans(arch, fabric, cache_dtype_bytes=4, act_dtype_bytes=4)
        jd, td = json.loads(jplan.to_json()), json.loads(tplan.to_json())
        _close_tree(td, jd)
        assert td == jd
        # each package reads the other's JSON and writes it back unchanged
        assert json.loads(ServePlan.from_json(jplan.to_json()).to_json()) == jd
        assert json.loads(JaxServePlan.from_json(tplan.to_json()).to_json()) == td
        assert tplan.describe() == jplan.describe()
        assert tplan.predicted_step_time() == jplan.predicted_step_time()
        assert tplan.capacity_tok_per_s(4) == jplan.capacity_tok_per_s(4)
        assert tplan.predicted_completion_s(16) == jplan.predicted_completion_s(16)


@pytest.mark.parametrize("policy", ["wfbp", "synceasgd", "dp_optimal"])
def test_policies_and_calibration_match_reference(policy, tmp_path):
    jplan, tplan = _plans("tinyllama-1.1b", "gpu_nccl", policy=policy)
    assert tplan.schedule.groups == jplan.schedule.groups
    jcal, tcal = jplan.with_step_fixed(3.25e-3), tplan.with_step_fixed(3.25e-3)
    assert json.loads(tcal.to_json()) == json.loads(jcal.to_json())
    assert tcal.group_summaries() == jcal.group_summaries()
    measured = tuple(np.random.default_rng(0).uniform(1e-5, 1e-3, len(tcal.group_summaries())))
    assert group_comparison_lines(tcal, measured) == jax_group_comparison_lines(jcal, measured)
    path = tcal.save(tmp_path / "serve_plan.json")
    assert JaxServePlan.load(path).to_json() == jcal.to_json()


def test_rebuild_and_refit_match_reference():
    jplan, tplan = _plans("mixtral-8x7b", "gpu_nccl", cache_dtype_bytes=4, act_dtype_bytes=4)
    assert tplan.op == jplan.op == "all_to_all"
    sizes = (4096, 262144, 4 * 1024 * 8**5)
    slow = {4096: 4e-4, 262144: 9e-4, 4 * 1024 * 8**5: 4e-2}
    jfit = jax_refit_serve_fit(slow.__getitem__, sizes)
    tfit = refit_serve_fit(slow.__getitem__, sizes)
    assert (tfit.a, tfit.b, tfit.name) == (jfit.a, jfit.b, jfit.name)
    jnew = jax_rebuild_serve_plan(jplan, JaxAllReduceModel(a=jfit.a, b=jfit.b, name="refit"))
    tnew = rebuild_serve_plan(tplan, AllReduceModel(a=tfit.a, b=tfit.b, name="refit"))
    assert json.loads(tnew.to_json()) == json.loads(jnew.to_json())
    assert tnew.provenance["refit"] == "degraded_fabric"


def test_mesh_functions_raise():
    """Without a ``DeviceMesh`` the timed serve collectives refuse to run, and a serve wire of an op no serve group
    issues is refused before any group is needed."""
    _, tplan = _plans("tinyllama-1.1b", "gpu_nccl")
    for call in (lambda: serve_collective_time_fn(None, "all_gather")(4096),
                 lambda: measure_serve_comm(None),
                 lambda: serve_fabric_fits(None),
                 lambda: time_serve_groups(tplan, None)):
        with pytest.raises(TypeError, match="expected a DeviceMesh"):
            call()
    _, rs_plan = _plans("tinyllama-1.1b", "gpu_nccl", op="reduce_scatter")
    with pytest.raises(ValueError, match="all_gather, all_to_all or all_reduce"):
        make_group_collective(rs_plan)
