"""Tuner and measured-cost parity: the port's ``planning.tuner`` and
``planning.costs`` against the JAX package's, on the same inputs.

Cost vectors, timed observations and injected comm timings are made from
a numpy seed and handed to both packages.  Schedules, candidate tables,
plan JSON and provenance must be exactly equal (the planning math is the
same Python on the same floats); floats are held to 1e-12 relative.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.configs import get_reduced as jax_get_reduced
from repro.core import bucketing as jax_bucketing
from repro.core.trainer import lm_unit_costs as jax_lm_unit_costs
from repro.fabric import MeasuredFabric as JaxMeasuredFabric, get_fabric as jax_get_fabric
from repro.launch.specs import param_specs
from repro.planning import (
    CommRefitter as JaxCommRefitter,
    MeasuredComm as JaxMeasuredComm,
    MeasuredCosts as JaxMeasuredCosts,
    Tuner as JaxTuner,
    comm_drift as jax_comm_drift,
    cost_drift as jax_cost_drift,
    default_policies as jax_default_policies,
    replan_if_comm_drifted as jax_replan_comm,
    replan_if_drifted as jax_replan,
)
from repro.planning.plan import build_plan as jax_build_plan
from _torch_registry import pristine_policy_registries  # noqa: F401  (autouse)
from repro_torch.configs import get_reduced
from repro_torch.core import bucketing
from repro_torch.core.comm_model import AllReduceModel
from repro_torch.core.trainer import lm_unit_costs
from repro_torch.fabric import MeasuredFabric, get_fabric
from repro_torch.models import param_shapes
from repro_torch.planning import (
    SLIM_COMM_SWEEP,
    CommRefitter,
    MeasuredComm,
    MeasuredCosts,
    Tuner,
    build_plan,
    comm_drift,
    cost_drift,
    default_policies,
    replan_if_comm_drifted,
    replan_if_drifted,
)

ARCHS = ["tinyllama-1.1b", "recurrentgemma-9b", "rwkv6-7b"]
TOKENS = 1024
REL = 1e-12


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0)


def _setup(arch, fabric="gpu_nccl", wire_bytes=4):
    jcfg, tcfg = jax_get_reduced(arch), get_reduced(arch)
    jshapes, tshapes = param_specs(jcfg), param_shapes(tcfg)
    jlayout = jax_bucketing.stacked_lm_layout(jshapes, jcfg.n_stages, comm_dtype_bytes=wire_bytes)
    tlayout = bucketing.stacked_lm_layout(tshapes, tcfg.n_stages, comm_dtype_bytes=wire_bytes)
    jcosts = jax_lm_unit_costs(jcfg, jshapes, TOKENS, comm_dtype_bytes=wire_bytes)
    tcosts = lm_unit_costs(tcfg, tshapes, TOKENS, comm_dtype_bytes=wire_bytes)
    jar = jax_get_fabric(fabric).cost("all_reduce", {"data": 32})
    tar = get_fabric(fabric).cost("all_reduce", {"data": 32})
    return jcfg, tcfg, jshapes, tshapes, jlayout, tlayout, jcosts, tcosts, jar, tar


def _seconds(n, seed, lo=1e-5, hi=1e-2):
    return list(np.exp(np.random.default_rng(seed).uniform(np.log(lo), np.log(hi), n)))


def _plan_dict(plan):
    return json.loads(plan.to_json())


@pytest.mark.parametrize("with_shapes", [False, True], ids=["no-shapes", "shapes"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sweep_matches_reference(arch, with_shapes):
    """Every policy scored the same, the same argmin, the same plan JSON,
    with measured unit times from a seed, with and without arena bytes."""
    jcfg, tcfg, jshapes, tshapes, jlay, tlay, jcosts, tcosts, jar, tar = _setup(arch)
    secs = _seconds(len(jcosts), seed=7)
    jm = JaxMeasuredCosts.from_unit_times(jcosts, secs, name="probe_segments")
    tm = MeasuredCosts.from_unit_times(tcosts, secs, name="probe_segments")
    jt = JaxTuner(layout=jlay, n_scan_stages=jcfg.n_stages,
                  shapes=jshapes if with_shapes else None, provenance={"arch": jcfg.name})
    tt = Tuner(layout=tlay, n_scan_stages=tcfg.n_stages,
               shapes=tshapes if with_shapes else None, provenance={"arch": tcfg.name})
    assert tt.policies == jt.policies == default_policies(tlay.num_layers)
    jplan = jt.sweep(jm.layer_costs(), jar, jm.hw, cost_source=jm.name, trigger="startup")
    tplan = tt.sweep(tm.layer_costs(), tar, tm.hw, cost_source=tm.name, trigger="startup")
    jrec, trec = jt.last_record.to_json_dict(), tt.last_record.to_json_dict()
    assert trec == jrec
    assert len(trec["candidates"]) == len(default_policies(tlay.num_layers))
    assert all((c["arena_bytes"] is not None) == with_shapes for c in trec["candidates"])
    assert _plan_dict(tplan) == _plan_dict(jplan)
    assert tplan.schedule.groups == jplan.schedule.groups


@pytest.mark.parametrize("mode", ["overlap", "serialized"])
def test_sweep_fabric_and_modes_match_reference(mode):
    jcfg, tcfg, jshapes, tshapes, jlay, tlay, jcosts, tcosts, jar, tar = _setup(ARCHS[0])
    jt = JaxTuner(layout=jlay, n_scan_stages=jcfg.n_stages)
    tt = Tuner(layout=tlay, n_scan_stages=tcfg.n_stages)
    from repro.core.cost_model import TPU_V5E as JHW
    from repro_torch.core.cost_model import TPU_V5E as THW

    jp = jt.sweep(jcosts, jar, JHW, mode=mode)
    tp = tt.sweep(tcosts, tar, THW, mode=mode)
    assert _plan_dict(tp) == _plan_dict(jp)
    jp = jt.sweep_fabric(jcosts, "paper_10gbe", {"data": 8}, JHW)
    tp = tt.sweep_fabric(tcosts, "paper_10gbe", {"data": 8}, THW)
    assert _plan_dict(tp) == _plan_dict(jp)
    assert tt.last_record.comm_source == jt.last_record.comm_source == "paper_10gbe"


def test_tuner_state_round_trips_across_packages():
    jcfg, tcfg, jshapes, tshapes, jlay, tlay, jcosts, tcosts, jar, tar = _setup(ARCHS[1])
    jt = JaxTuner(layout=jlay, n_scan_stages=jcfg.n_stages, shapes=jshapes)
    tt = Tuner(layout=tlay, n_scan_stages=tcfg.n_stages, shapes=tshapes)
    for seed in (1, 2):
        secs = _seconds(len(jcosts), seed)
        jm = JaxMeasuredCosts.from_unit_times(jcosts, secs)
        tm = MeasuredCosts.from_unit_times(tcosts, secs)
        jt.sweep(jm.layer_costs(), jar, jm.hw, trigger="cost_drift")
        tt.sweep(tm.layer_costs(), tar, tm.hw, trigger="cost_drift")
    jt.observe(0.0123)
    tt.observe(0.0123)
    jst, tst = jt.state_dict(), tt.state_dict()
    assert json.loads(json.dumps(tst)) == json.loads(json.dumps(jst))
    back = Tuner(layout=tlay).load_state(json.loads(json.dumps(jst)))
    assert back.state_dict() == tst
    fwd = JaxTuner(layout=jlay).load_state(json.loads(json.dumps(tst)))
    assert fwd.state_dict() == jst
    with pytest.raises(ValueError, match="format"):
        Tuner(layout=tlay).load_state({"format": 99})
    with pytest.raises(ValueError, match="before any sweep"):
        Tuner(layout=tlay).observe(1.0)


def _cost_fields(costs):
    return [dataclasses.asdict(c) for c in costs]


@pytest.mark.parametrize("arch", ARCHS)
def test_measured_costs_match_reference(arch):
    from repro.core.cost_model import TPU_V5E as JHW
    from repro_torch.core.cost_model import TPU_V5E as THW

    _, _, _, _, _, _, jcosts, tcosts, _, _ = _setup(arch)
    n = len(jcosts)
    bwd, fwd = _seconds(n, 3), _seconds(n, 4)
    pairs = [
        (JaxMeasuredCosts.from_unit_times(jcosts, bwd, fwd),
         MeasuredCosts.from_unit_times(tcosts, bwd, fwd)),
        (JaxMeasuredCosts.from_step_timing(jcosts, JHW, 0.0371, 0.0123),
         MeasuredCosts.from_step_timing(tcosts, THW, 0.0371, 0.0123)),
        (JaxMeasuredCosts.from_segment_times(
            jcosts, JHW, {"embed": 1e-4, "stage_0": 3e-3, "head": 2e-3}),
         MeasuredCosts.from_segment_times(
            tcosts, THW, {"embed": 1e-4, "stage_0": 3e-3, "head": 2e-3})),
    ]
    for jm, tm in pairs:
        assert tm.name == jm.name and tm.hw.name == jm.hw.name
        for jc, tc in zip(_cost_fields(jm.costs), _cost_fields(tm.costs)):
            assert jc.keys() == tc.keys()
            for k in jc:
                if isinstance(jc[k], float):
                    _close(tc[k], jc[k])
                else:
                    assert tc[k] == jc[k]
    with pytest.raises(ValueError):
        MeasuredCosts.from_unit_times(tcosts, bwd[:-1])
    with pytest.raises(ValueError):
        MeasuredCosts.from_step_timing(tcosts, THW, 0.0, 1.0)


@pytest.mark.parametrize("side", ["below", "at", "above"])
def test_replan_if_drifted_at_the_threshold(side):
    """A measured vector whose largest per-unit drift is exactly d; the
    threshold at d, just above and just below it."""
    from repro.core.cost_model import TPU_V5E as JHW
    from repro_torch.core.cost_model import TPU_V5E as THW

    jcfg, tcfg, _, _, jlay, tlay, jcosts, tcosts, jar, tar = _setup(ARCHS[0])
    jplan = jax_build_plan(jlay, jcosts, jar, policy="mg_wfbp", hw=JHW,
                           n_scan_stages=jcfg.n_stages)
    tplan = build_plan(tlay, tcosts, tar, policy="mg_wfbp", hw=THW, n_scan_stages=tcfg.n_stages)
    base = [c.t_b(THW) for c in tcosts]
    scale = np.ones(len(base))
    scale[2] = 4.0  # stage_1's backward 4x slower: drift 3.0 (plus rounding)
    bwd = list(np.asarray(base) * scale)
    jm = JaxMeasuredCosts.from_unit_times(jcosts, bwd)
    tm = MeasuredCosts.from_unit_times(tcosts, bwd)
    d = cost_drift(tplan, tm)
    assert d == jax_cost_drift(jplan, jm)
    thr = {"below": np.nextafter(d, 0.0), "at": d, "above": np.nextafter(d, 1e9)}[side]
    jnew, jre = jax_replan(jplan, jm, threshold=thr)
    tnew, tre = replan_if_drifted(tplan, tm, threshold=thr)
    assert tre == jre == (side == "below")
    assert _plan_dict(tnew) == _plan_dict(jnew)
    if tre:
        assert tnew.provenance["drift"] == f"{d:.4f}"
    else:
        assert tnew is tplan


@pytest.mark.parametrize("side", ["below", "at", "above"])
def test_replan_if_comm_drifted_at_the_threshold(side):
    from repro.core.comm_model import AllReduceModel as JaxAR
    from repro.core.cost_model import TPU_V5E as JHW
    from repro_torch.core.cost_model import TPU_V5E as THW

    jcfg, tcfg, _, _, jlay, tlay, jcosts, tcosts, jar, tar = _setup(ARCHS[2])
    jplan = jax_build_plan(jlay, jcosts, jar, policy="mg_wfbp", hw=JHW,
                           n_scan_stages=jcfg.n_stages)
    tplan = build_plan(tlay, tcosts, tar, policy="mg_wfbp", hw=THW, n_scan_stages=tcfg.n_stages)
    jfit = JaxAR(a=jar.a * 10, b=jar.b * 1.5, name="fresh")
    tfit = AllReduceModel(a=tar.a * 10, b=tar.b * 1.5, name="fresh")
    d = comm_drift(tplan.ar_model, tfit)
    assert d == jax_comm_drift(jplan.ar_model, jfit)
    thr = {"below": np.nextafter(d, 0.0), "at": d, "above": np.nextafter(d, 1e9)}[side]
    jnew, jre = jax_replan_comm(jplan, jfit, threshold=thr)
    tnew, tre = replan_if_comm_drifted(tplan, tfit, threshold=thr)
    assert tre == jre == (side == "below")
    assert _plan_dict(tnew) == _plan_dict(jnew)


def test_measured_comm_update_fit_and_fabric_match_reference():
    rng = np.random.default_rng(11)
    sizes = tuple(int(s) for s in (4096 * 8 ** np.arange(6)))
    times = tuple(float(t) for t in 3e-5 + 2e-10 * np.asarray(sizes) * rng.uniform(0.9, 1.1, 6))
    jmc = JaxMeasuredComm(sizes_bytes=sizes, times_s=times)
    tmc = MeasuredComm(sizes_bytes=sizes, times_s=times)
    fresh_sizes = (4096, 12345, 2 ** 27)
    fresh = tuple(float(t) for t in rng.uniform(1e-5, 1e-2, 3))
    for w in (0.5, 1.0, 0.25):
        jmc, tmc = jmc.update(fresh_sizes, fresh, weight=w), tmc.update(fresh_sizes, fresh, weight=w)
        assert tmc.sizes_bytes == jmc.sizes_bytes
        for a, b in zip(tmc.times_s, jmc.times_s):
            _close(a, b)
        jf, tf = jmc.fit(), tmc.fit()
        assert tf.name == jf.name
        _close(tf.a, jf.a)
        _close(tf.b, jf.b)
    with pytest.raises(ValueError, match="EWMA"):
        tmc.update(fresh_sizes, fresh, weight=0.0)
    jfab, tfab = JaxMeasuredFabric.from_comm(jmc), MeasuredFabric.from_comm(tmc)
    for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all"):
        jc, tc = jfab.cost(op, {"data": 4}), tfab.cost(op, {"data": 4})
        assert tc.name == jc.name
        _close(tc.a, jc.a)
        _close(tc.b, jc.b)
    over = {"all_gather@data": AllReduceModel(a=1e-6, b=1e-12, name="ag")}
    assert tfab.with_fits(over).cost("all_gather", {"data": 2}).a == 1e-6
    with pytest.raises(KeyError, match="no measured fit"):
        tfab.cost("all_reduce", {"model": 2})


def test_comm_refitter_matches_reference_under_alpha_times_10():
    """An injected time_fn whose α jumps x10 after two checks: the same
    drift readings, the same refit, the same state on both sides."""
    sizes = tuple(4096 * 8 ** i for i in range(6))
    base_a, base_b = 2e-5, 5e-10
    times = tuple(base_a + base_b * s for s in sizes)
    jr = JaxCommRefitter(base=JaxMeasuredComm(sizes_bytes=sizes, times_s=times), threshold=0.25)
    tr = CommRefitter(base=MeasuredComm(sizes_bytes=sizes, times_s=times), threshold=0.25)
    assert tr.probe_sizes == jr.probe_sizes == SLIM_COMM_SWEEP
    rng = np.random.default_rng(5)
    for k in range(6):
        a = base_a * (10.0 if k >= 2 else 1.0)
        noise = rng.uniform(0.98, 1.02)

        def time_fn(nbytes, a=a, noise=noise):
            return (a + base_b * nbytes) * noise

        jfit, jd, jdr = jr.check(time_fn)
        tfit, td, tdr = tr.check(time_fn)
        assert tdr == jdr
        _close(td, jd)
        _close(tfit.a, jfit.a)
        _close(tfit.b, jfit.b)
    assert tr.refits == jr.refits >= 1 and tr.checks == jr.checks == 6
    jst, tst = jr.state_dict(), tr.state_dict()
    assert json.loads(json.dumps(tst)) == json.loads(json.dumps(jst))
    back = CommRefitter.from_state_dict(json.loads(json.dumps(jst)))
    assert back.state_dict() == tst
    fwd = JaxCommRefitter.from_state_dict(json.loads(json.dumps(tst)))
    assert fwd.state_dict() == jst


def test_comm_refitter_replan_matches_reference():
    from repro.core.cost_model import TPU_V5E as JHW
    from repro_torch.core.cost_model import TPU_V5E as THW

    jcfg, tcfg, _, _, jlay, tlay, jcosts, tcosts, jar, tar = _setup(ARCHS[0])
    jplan = jax_build_plan(jlay, jcosts, jar, policy="wfbp", hw=JHW, n_scan_stages=jcfg.n_stages)
    tplan = build_plan(tlay, tcosts, tar, policy="wfbp", hw=THW, n_scan_stages=tcfg.n_stages)
    sizes = (4096, 32768, 262144)
    times = (1e-4, 1.2e-4, 3e-4)
    jr = JaxCommRefitter(base=JaxMeasuredComm(sizes_bytes=sizes, times_s=times))
    tr = CommRefitter(base=MeasuredComm(sizes_bytes=sizes, times_s=times))
    jnew, jre = jr.replan(jplan, jr.reference)
    tnew, tre = tr.replan(tplan, tr.reference)
    assert tre == jre
    assert _plan_dict(tnew) == _plan_dict(jnew)


def test_default_policies_match_reference():
    for n in (1, 6, 14, 15, 24, 40):
        assert default_policies(n) == jax_default_policies(n)
    assert "optimal" not in default_policies(24)
