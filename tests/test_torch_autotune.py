"""The measured-cost loop of the port: unit probes against the JAX
package's, probes that leave the live step alone, and the launcher's
``--autotune`` / ``--measure-comm`` / re-planning / ``--dryrun`` flags on
the CPU.

* ``probe_unit_times``: each package's ``time_segment`` is patched to
  return the same seconds per probe kind; the unit keys, the seconds and
  the resulting ``MeasuredCosts`` vectors must be equal, for reduced
  TinyLlama, RecurrentGemma and RWKV6.
* A re-plan hands the optimizer state and the EF residual to the new step:
  a run that adopts other plans mid-run (injected unit times) must be
  bitwise equal to one that never re-plans, at world 1 with f32 wire and
  with ``bf16_ef``, and on 2 gloo ranks.
* Ranks given different probe times adopt rank 0's plan and end with
  equal parameters.
"""

import json
import math
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from _env import REPO_ROOT, SUBPROC_ENV
from _torch_env import bits, world1
from repro.configs import get_reduced as jax_get_reduced
from repro.core import bucketing as jax_bucketing
from repro.core.cost_model import TPU_V5E as JHW
from repro.core.trainer import lm_unit_costs as jax_lm_unit_costs
from repro.launch.specs import param_specs
from repro.models.transformer import init_params
from repro.planning import MeasuredCosts as JaxMeasuredCosts
from repro.runtime import timeline as jax_timeline
from repro_torch.configs import get_reduced
from repro_torch.core import bucketing
from repro_torch.core.comm_model import AllReduceModel
from repro_torch.core.cost_model import TPU_V5E as THW
from repro_torch.core.sync import SyncConfig
from repro_torch.core.trainer import MGWFBPEngine, batch_to_device, lm_unit_costs
from repro_torch.data import DataConfig, make_stream
from repro_torch.fabric.ops import issue
from repro_torch.launch.train import run
from repro_torch.models import Transformer, param_shapes
from repro_torch.optim import make_optimizer
from repro_torch.planning import MeasuredCosts, default_policies
from repro_torch.runtime import UnitProfile, make_unit_probes, probe_unit_times
from repro_torch.runtime import timeline as torch_timeline

ARCHS = ["tinyllama-1.1b", "recurrentgemma-9b", "rwkv6-7b"]
KIND_SECONDS = {"embed": 1.25e-4, "stage": 3.5e-3, "tail": 2.0e-3, "head": 1.1e-3}


def _batch(vocab, seq=32, batch=2, step=0):
    return make_stream(DataConfig(vocab=vocab, seq_len=seq, global_batch=batch)).batch_at(step)


def _fake_time_segment(probes):
    kind_of = {id(fn): kind for kind, (fn, _) in probes.items()}

    def fake(fn, *args, **kwargs):
        return KIND_SECONDS[kind_of[id(fn)]]

    return fake


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_unit_times_matches_reference(arch, monkeypatch):
    jcfg = jax_get_reduced(arch)
    tcfg = get_reduced(arch, param_dtype=torch.float32)
    np_batch = _batch(tcfg.vocab)
    jbatch = jax.tree.map(jax.numpy.asarray, np_batch)
    tbatch = batch_to_device(np_batch, torch.device("cpu"))
    jparams = init_params(jax.random.PRNGKey(0), jcfg)
    model = Transformer(tcfg, device="cpu", seed=0)
    jprobes = jax_timeline.make_unit_probes(jcfg, jparams, jbatch)
    tprobes = make_unit_probes(tcfg, model, tbatch)
    assert sorted(tprobes) == sorted(jprobes)
    assert ("tail" in tprobes) == bool(tcfg.tail_pattern)
    monkeypatch.setattr(jax_timeline, "time_segment", _fake_time_segment(jprobes))
    monkeypatch.setattr(torch_timeline, "time_segment", _fake_time_segment(tprobes))
    jshapes, tshapes = param_specs(jcfg), param_shapes(tcfg)
    jlay = jax_bucketing.stacked_lm_layout(jshapes, jcfg.n_stages)
    tlay = bucketing.stacked_lm_layout(tshapes, tcfg.n_stages)
    jprof = jax_timeline.probe_unit_times(jcfg, jparams, jbatch, jlay, probes=jprobes)
    tprof = probe_unit_times(tcfg, model, tbatch, tlay, probes=tprobes)
    assert list(tprof.unit_seconds) == list(jprof.unit_seconds) == [u.name for u in tlay.units]
    assert tprof.unit_seconds == jprof.unit_seconds
    jcosts = jax_lm_unit_costs(jcfg, jshapes, 64)
    tcosts = lm_unit_costs(tcfg, tshapes, 64)
    jm = JaxMeasuredCosts.from_segment_times(jcosts, JHW, jprof.unit_seconds)
    tm = MeasuredCosts.from_segment_times(tcosts, THW, tprof.unit_seconds)
    assert [(c.name, c.params, c.grad_bytes, c.bwd_flops, c.fwd_flops) for c in tm.costs] == \
        [(c.name, c.params, c.grad_bytes, c.bwd_flops, c.fwd_flops) for c in jm.costs]
    assert tprof.ratios(tcosts, THW) == jprof.ratios(jcosts, JHW)
    assert tprof.nonuniformity(tcosts, THW) == jprof.nonuniformity(jcosts, JHW)
    assert UnitProfile({}).nonuniformity(tcosts, THW) == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_probes_leave_the_live_dag_step_alone(arch):
    """A probe pass between two ``dag`` steps writes no ``.grad``, fires no
    hook, issues nothing; the next step issues every group as before."""
    world1()
    cfg = get_reduced(arch, param_dtype=torch.float32)
    eng = MGWFBPEngine.build(cfg, param_shapes(cfg), ar_model=AllReduceModel(a=5e-5, b=1e-9),
                             tokens_per_device=64, policy="wfbp",
                             sync_config=SyncConfig(fuse="arena"))
    model = Transformer(cfg, device="cpu", seed=0)
    step = eng.make_train_step(model, make_optimizer("adamw"), issue="dag")
    batch = batch_to_device(_batch(cfg.vocab), torch.device("cpu"))
    try:
        step(batch)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        weights = {n: p.detach().clone() for n, p in model.named_parameters()}
        calls = issue.calls
        prof = probe_unit_times(cfg, model, batch, eng.plan.layout, repeats=1, warmup=0)
        assert issue.calls == calls and step._pending == []
        for n, p in model.named_parameters():
            assert torch.equal(p.grad, grads[n]) and torch.equal(p.detach(), weights[n]), n
        assert list(prof.unit_seconds) == [u.name for u in eng.plan.layout.units]
        assert all(math.isfinite(s) and s > 0 for s in prof.unit_seconds.values())
        step(batch)
        assert issue.calls == calls + eng.sync.n_groups
    finally:
        step.close()


def test_timed_all_reduces_at_world1():
    """The comm side on a gloo world of one: a fit per axis, finite and
    >= 0 (a negative slope is clamped, as the JAX fit does); one time per
    group payload; the refit's time_fn; none of it through ``issue()``."""
    from repro_torch.planning import measure_comm_models, psum_time_fn
    from repro_torch.runtime import time_group_comm

    world1()
    calls = issue.calls
    fits = measure_comm_models(sizes_bytes=(4096, 65536, 1 << 20), repeats=2)
    assert list(fits) == ["data"]
    assert all(math.isfinite(v) and v >= 0 for v in (fits["data"].a, fits["data"].b))
    times = time_group_comm(None, [1000, 4096, 1 << 16])
    assert len(times) == 3 and all(t > 0 for t in times)
    time_fn = psum_time_fn(device="cpu")
    assert time_fn(4096) > 0 and time_fn(4096) > 0
    assert issue.calls == calls


BASE = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "2", "--seq", "32",
        "--fuse", "arena", "--device", "cpu", "--issue-order", "dag"]
#: unit seconds that make the sweep pick 1 group, then 2 (reduced TinyLlama)
TINY, LARGE = 1e-7, 1e-3
UNITS = ["embed", "stage_0", "stage_1", "stage_2", "stage_3", "head"]


def _scripted(*values):
    """A stand-in probe pass: the k-th call gives every unit ``values[k]``
    (the last value from then on)."""
    calls = []

    def measure():
        v = values[min(len(calls), len(values) - 1)]
        calls.append(v)
        return {u: v for u in UNITS}

    return measure


def _params(model):
    return {n: bits(p) for n, p in model.named_parameters()}


def test_autotune_cli_flags_on_cpu(capsys):
    world1()
    res = run(BASE + ["--steps", "5", "--autotune", "--measure-comm", "--replan-every", "2",
                      "--comm-refit-every", "2"])
    out = capsys.readouterr().out
    assert "[train] measured comm fit:" in out
    assert "[train] autotune startup sweep" in out and "6 candidates" in out
    first = res.tuner_history[0]
    assert first.trigger == "startup" and first.cost_source == "probe_segments"
    assert sorted(c.policy for c in first.candidates) == sorted(default_policies(6))
    prof = res.unit_profiles[0]
    assert list(prof.unit_seconds) == sorted(UNITS)
    assert all(math.isfinite(s) and s > 0 for s in prof.unit_seconds.values())
    fit = res.comm_model
    assert fit.name.startswith("measured") and math.isfinite(fit.a) and fit.a >= 0 and fit.b >= 0
    assert len(res.losses) == 5 and all(math.isfinite(x) for x in res.losses)
    assert [d.get("issue", 0) for d in res.step_launches] == res.step_groups
    assert res.plan.provenance["tuner"] in ("startup", "cost_drift", "comm_drift")


def test_forced_replan_is_bitwise_equal_to_an_unbroken_run_world1():
    """Startup adopts 1 group, the drift check at step 7 adopts 2: the
    losses and weights stay bitwise those of a run on the analytic plan
    (f32 wire at world 1: the grouping changes no arithmetic)."""
    world1()
    for comp in ([], ["--compression", "bf16_ef"]):
        plain = run(BASE + ["--steps", "12"] + comp, quiet=True)
        tuned = run(BASE + ["--steps", "12", "--autotune", "--replan-every", "7"] + comp,
                    quiet=True, measure_units=_scripted(TINY, LARGE))
        assert [r.trigger for r in tuned.tuner_history] == ["startup", "cost_drift"]
        assert tuned.step_groups == [1] * 8 + [2] * 4
        # the closing observe: steps 10-11 (two skipped after the re-plan)
        assert tuned.tuner_history[0].observed_t_iter is not None
        assert tuned.tuner_history[1].observed_t_iter is not None
        assert len(set(plain.step_groups)) == 1
        assert tuned.losses == plain.losses
        assert _params(tuned.model).keys() == _params(plain.model).keys()
        for n, b in _params(plain.model).items():
            assert np.array_equal(_params(tuned.model)[n], b), n


def test_dryrun_reports_the_recorded_spans(tmp_path):
    from repro.core.profiler import overlap_report as jax_overlap_report
    from repro.core.profiler import parse_trace_spans as jax_parse

    world1()
    out = tmp_path / "trace.json.gz"
    res = run(BASE + ["--autotune", "--dryrun", "3", "--trace-out", str(out)], quiet=True,
              measure_units=_scripted(LARGE))
    groups = res.engine.sync.n_groups
    assert groups == 2 and len(res.losses) == 3
    assert res.report["n_comm_spans"] == groups * 2
    assert res.report["n_bwd_spans"] == 2 * (2 + 4)
    assert jax_overlap_report(jax_parse(out))["n_comm_spans"] == groups * 2


def test_plan_in_with_autotune_is_refused(tmp_path, capsys):
    world1()
    plan = tmp_path / "plan.json"
    run(BASE + ["--steps", "1", "--plan-out", str(plan)], quiet=True)
    with pytest.raises(SystemExit) as e:
        run(BASE + ["--steps", "1", "--plan-in", str(plan), "--autotune"], quiet=True)
    assert e.value.code == 2
    assert "mutually exclusive" in capsys.readouterr().err


RANKS_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch, torch.distributed as dist
    from repro_torch.launch.train import run

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    base = json.loads(sys.argv[4])
    units = ["embed", "stage_0", "stage_1", "stage_2", "stage_3", "head"]
    # rank 1's own probe times alone would pick 2 groups at startup, then 1
    script = [1e-7, 1e-3] if rank == 0 else [1e-3, 1e-7]
    calls = []

    def measure():
        v = script[min(len(calls), 1)]
        calls.append(v)
        return {u: v for u in units}

    def constant():
        return {u: 1e-7 * (1 + rank) for u in units}

    result = {}
    for tag, extra, fake in (
            ("plain", [], None),
            ("tuned", ["--autotune", "--replan-every", "7"], measure),
            ("refit", ["--autotune", "--measure-comm", "--comm-refit-every", "2",
                       "--comm-drift-threshold", "0.01", "--steps", "6"], constant)):
        res = run(base + extra, quiet=True, measure_units=fake)
        torch.save({n: p.detach() for n, p in res.model.named_parameters()},
                   f"{out}/{tag}_{rank}.pt")
        result[tag] = {"losses": res.losses, "groups": res.step_groups,
                       "chosen": [r.chosen for r in res.tuner_history],
                       "triggers": [r.trigger for r in res.tuner_history],
                       "issue": [d.get("issue", 0) for d in res.step_launches],
                       "fit": [res.comm_model.a, res.comm_model.b]}
    dist.destroy_process_group()
    print(json.dumps(result))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("comp", [None, "bf16_ef"])
def test_two_gloo_ranks_agree_and_replans_are_bitwise(comp, tmp_path):
    """2 gloo ranks, each with its own probe times and its own timed
    all-reduces: both adopt rank 0's plans, the same at every step, and
    both end bitwise equal to an unbroken 2-rank run and to each other.
    A third run measures (α, β) and re-fits it every 2 steps at a 1% drift
    threshold: the ranks' re-sweeps, from their own timings broadcast from
    rank 0, match."""
    base = BASE + ["--batch", "4", "--steps", "10"] + (["--compression", comp] if comp else [])
    port = _free_port()
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", RANKS_SCRIPT, str(r), str(port), str(tmp_path),
             json.dumps(base)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO_ROOT,
        )
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, stderr[-3000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    r0, r1 = outs
    for tag in ("tuned", "refit"):
        for key in ("groups", "chosen", "triggers", "issue", "fit", "losses"):
            assert r0[tag][key] == r1[tag][key], (tag, key)
    # the refit run re-sweeps on every drifted comm check, on both ranks alike
    assert r0["refit"]["triggers"][0] == "startup"
    assert r0["refit"]["losses"] == r0["plain"]["losses"][:6]
    # rank 0's probe times: 1 group from startup, 2 after the drift check
    assert r0["tuned"]["triggers"][:2] == ["startup", "cost_drift"]
    assert r0["tuned"]["groups"][:8] == [1] * 8
    assert r0["tuned"]["issue"] == r0["tuned"]["groups"]
    assert r0["tuned"]["losses"] == r0["plain"]["losses"] == r1["plain"]["losses"]
    want = torch.load(tmp_path / "plain_0.pt")
    for name in ("plain_1", "tuned_0", "tuned_1"):
        got = torch.load(tmp_path / f"{name}.pt")
        for n, t in want.items():
            assert np.array_equal(bits(got[n]), bits(t)), (name, n)


STEP_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from repro_torch.planning import MeasuredComm, psum_time_fn, rank0_values, time_collective_call

    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    calls = [0]

    def f(v):
        calls[0] += 1
        dist.all_reduce(v)

    # rank 1's second sample is a 50x outlier, which min_of_k re-takes on its
    # own samples; rank 0's samples are even
    ticks = iter([0.0, 1.0, 1.0, 2.0, 2.0, 3.0] if rank == 0 else
                 [0.0, 1.0, 1.0, 51.0, 51.0, 52.0, 52.0, 53.0])
    t = time_collective_call(f, torch.zeros(4), repeats=3, clock=lambda: next(ticks),
                             agree=lambda s: rank0_values([s])[0])
    mc = MeasuredComm.time_psums(sizes_bytes=(4096, 65536, 1 << 20), repeats=3)
    probe = psum_time_fn(device="cpu")
    print(json.dumps({"t": t, "calls": calls[0], "times": list(mc.times_s),
                      "probe": [probe(4096), probe(1 << 20)]}))
    dist.destroy_process_group()
""")


def test_timed_all_reduces_stay_in_step_across_ranks():
    """A timed sample re-taken on one rank only would give that rank one
    more all-reduce than the other (a hang or a mismatched collective):
    every sample is rank 0's on both ranks, so both make the same calls
    and hold the same times."""
    port = _free_port()
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", STEP_SCRIPT, str(r), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                         cwd=REPO_ROOT)
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr[-3000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert outs[0] == outs[1]
    assert outs[0]["t"] == 1.0 and outs[0]["calls"] == 4  # one warm-up, three samples
