"""Serving resilience of the port (``repro_torch.serving.resilience``) held
against the JAX package's, on reduced configs with f32 weights bridged by
``from_jax_params``.

* The JAX tests' ``TestSnapshotRestore``, ``TestChaosServeLoop`` and
  ``TestDegradedReplan`` (``tests/test_resilience.py``), each on the port:
  a restore resumes token for token, a geometry mismatch is refused, partial
  writes are ignored, a mixed directory lands on step 4 with 2 fallbacks,
  an all-corrupt directory raises, a kill mid-run gives the unbroken
  tokens, a corrupt snapshot falls back, each step kills at most once,
  deadlines shed and expire, the stop flag snapshots, a degraded wire
  changes the merge decision.  Every loop runs on an injected clock
  (``FakeClock``) with ``backoff_base_s=0``.
* Cross-package: the port's ``resilient_serve_loop`` and the JAX one, on
  the same weights, prompts, ``ChaosConfig`` and clock, give equal tokens
  per request and equal ``ServeReport`` counters (kills, a corrupt snapshot
  and a partial write, seeded kill draws, deadlines, a slowed wire); the
  injectors draw the same kill steps and ``for_replica`` the same seeds;
  reduced RecurrentGemma and RWKV6 killed and restored equal their unbroken
  runs and the JAX loop.
* Port only: a byte flipped in ``tensors.bin`` makes ``load_snapshot``
  raise with the engine untouched, and the restore fall back; a restore
  keeps every state tensor's storage (``data_ptr``); a seeded
  ``gumbel_sampler`` run killed and restored repeats the unbroken run.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.launch.specs import param_specs
from repro.models.transformer import init_params
from repro.planning import build_serve_plan as jax_build_serve_plan
from repro.runtime import StragglerMonitor as JaxStragglerMonitor
from repro.serving import ChaosConfig as JaxChaosConfig
from repro.serving import ChaosError as JaxChaosError
from repro.serving import ChaosInjector as JaxChaosInjector
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import resilient_serve_loop as jax_resilient_serve_loop
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.comm_model import AllReduceModel
from repro_torch.models import Transformer, from_jax_params, load_arrays, param_shapes
from repro_torch.models.transformer import tree_leaves
from repro_torch.planning import build_serve_plan, rebuild_serve_plan, refit_serve_fit
from repro_torch.runtime import StragglerMonitor
from repro_torch.serving import (
    ChaosConfig,
    ChaosError,
    ChaosInjector,
    Request,
    ServingEngine,
    gumbel_sampler,
    latest_snapshot,
    load_snapshot,
    resilient_serve_loop,
    restore_latest_snapshot,
    save_snapshot,
    snapshot_engine,
)


def _bridged(arch):
    jcfg = jax_get_reduced(arch, param_dtype=jnp.float32)
    tcfg = get_reduced(arch, param_dtype=torch.float32)
    params = init_params(jax.random.PRNGKey(0), jcfg)
    model = Transformer(tcfg, device="cpu", seed=None)
    load_arrays(model, from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module")
def setup():
    return _bridged("tinyllama-1.1b")


def make_engine(setup, **kw):
    _, tcfg, _, model = setup
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 64)
    return ServingEngine(tcfg, model, **kw)


def make_jax_engine(setup, **kw):
    jcfg, _, params, _ = setup
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 64)
    return JaxServingEngine(jcfg, params, **kw)


def submit_all(eng, n=3, max_new=6, deadline_s=None, request=Request):
    for rid in range(n):
        eng.submit(request(rid=rid, prompt=np.arange(3 + rid, dtype=np.int32) + 1,
                           max_new_tokens=max_new, deadline_s=deadline_s))


@pytest.fixture(scope="module")
def baseline_tokens(setup):
    """The uninterrupted run: the tokens every resilient run reproduces."""
    eng = make_engine(setup)
    submit_all(eng)
    while eng.active or eng.waiting:
        eng.step()
    return {r.rid: r.generated for r in eng.completed}


class FakeClock:
    """Deterministic loop clock: advances a fixed amount per call."""

    def __init__(self, dt=0.25):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


def loop(eng, tmp, **kw):
    kw.setdefault("backoff_base_s", 0.0)
    kw.setdefault("clock", FakeClock())
    return resilient_serve_loop(eng, snapshot_dir=str(tmp), **kw)


def tokens(report):
    return {r.rid: r.generated for r in report.completed}


# ---------------------------------------------------------------------------
# snapshot / restore (the JAX TestSnapshotRestore, on the port)
# ---------------------------------------------------------------------------


class TestSnapshotRestore:
    def test_restore_resumes_token_identical(self, setup, baseline_tokens, tmp_path):
        eng = make_engine(setup)
        submit_all(eng)
        for _ in range(3):
            eng.step()
        save_snapshot(eng, str(tmp_path), 3)

        fresh = make_engine(setup)
        step, skipped = restore_latest_snapshot(fresh, str(tmp_path))
        assert step == 3 and skipped == 0
        while fresh.active or fresh.waiting:
            fresh.step()
        assert {r.rid: r.generated for r in fresh.completed} == baseline_tokens

    def test_geometry_mismatch_rejected(self, setup):
        eng = make_engine(setup)
        snap = snapshot_engine(eng, 0)
        other = make_engine(setup, max_seq=32)
        with pytest.raises(ValueError, match="geometry"):
            other.restore_snapshot(snap)

    def test_partial_write_ignored(self, setup, tmp_path):
        eng = make_engine(setup)
        submit_all(eng)
        save_snapshot(eng, str(tmp_path), 3)
        ChaosInjector(ChaosConfig(seed=1)).partial_write(str(tmp_path), 5)
        assert latest_snapshot(str(tmp_path)) == 3

    def test_mixed_directory_lands_on_newest_complete(self, setup, tmp_path):
        """Complete snapshots at 2/4/6/8, the two newest corrupted, partial
        writes newer than all: the restore skips the partials, counts one
        fallback per corrupt snapshot and lands on step 4."""
        eng = make_engine(setup)
        submit_all(eng, n=2, max_new=12)
        want_row_pos = {}
        for step in (2, 4, 6, 8):
            eng.step()
            eng.step()
            save_snapshot(eng, str(tmp_path), step)
            want_row_pos[step] = eng.row_pos.copy()
        inj = ChaosInjector(ChaosConfig(seed=11))
        inj.corrupt_snapshot(str(tmp_path), 8)
        inj.corrupt_snapshot(str(tmp_path), 6)
        inj.partial_write(str(tmp_path), 9)
        inj.partial_write(str(tmp_path), 11)

        fresh = make_engine(setup)
        step, skipped = restore_latest_snapshot(fresh, str(tmp_path))
        assert step == 4
        assert skipped == 2
        assert np.array_equal(fresh.row_pos, want_row_pos[4])

    def test_all_snapshots_corrupt_raises(self, setup, tmp_path):
        eng = make_engine(setup)
        submit_all(eng)
        inj = ChaosInjector(ChaosConfig(seed=2))
        for step in (1, 2):
            eng.step()
            save_snapshot(eng, str(tmp_path), step)
            inj.corrupt_snapshot(str(tmp_path), step)
        fresh = make_engine(setup)
        with pytest.raises(RuntimeError, match="no loadable serve snapshot"):
            restore_latest_snapshot(fresh, str(tmp_path))


# ---------------------------------------------------------------------------
# the chaos serve loop (the JAX TestChaosServeLoop, on the port)
# ---------------------------------------------------------------------------


class TestChaosServeLoop:
    def test_kill_midrun_restores_identical_tokens(self, setup, baseline_tokens, tmp_path):
        eng = make_engine(setup)
        submit_all(eng)
        report = loop(eng, tmp_path, snapshot_every=2,
                      chaos=ChaosInjector(ChaosConfig(seed=7, kill_at=(4,))))
        assert report.restarts == 1
        assert len(report.recovery_times_s) == 1
        assert tokens(report) == baseline_tokens
        assert report.goodput_tokens == sum(len(t) for t in baseline_tokens.values())

    def test_corrupt_snapshot_falls_back_to_older(self, setup, baseline_tokens, tmp_path):
        eng = make_engine(setup)
        submit_all(eng)
        report = loop(eng, tmp_path, snapshot_every=2, chaos=ChaosInjector(ChaosConfig(
            seed=7, kill_at=(5,), corrupt_snapshot_at=4, partial_write_at=4)))
        assert report.snapshot_fallbacks >= 1
        assert tokens(report) == baseline_tokens

    def test_seeded_kills_deterministic(self):
        assert _kill_steps(ChaosInjector, ChaosConfig, ChaosError, 5) == \
            _kill_steps(ChaosInjector, ChaosConfig, ChaosError, 5)
        assert _kill_steps(ChaosInjector, ChaosConfig, ChaosError, 5) != \
            _kill_steps(ChaosInjector, ChaosConfig, ChaosError, 6)

    def test_each_step_kills_at_most_once(self):
        inj = ChaosInjector(ChaosConfig(seed=0, kill_at=(4,)))
        with pytest.raises(ChaosError):
            inj.fault_injector(4)
        inj.fault_injector(4)  # a restored replay of the same step: no second kill

    def test_deadline_shed_and_expire(self, setup, tmp_path):
        eng = make_engine(setup, slots=2, max_seq=64)
        _deadline_requests(eng, Request)
        report = loop(eng, tmp_path, snapshot_every=100, clock=FakeClock(0.25))
        by_rid = {r.rid: r for r in report.completed}
        assert report.shed == 1 and by_rid[2].shed and not by_rid[2].generated
        assert report.expired == 1 and by_rid[1].expired
        assert 0 < len(by_rid[1].generated) < 50  # a graceful partial output
        assert len(by_rid[0].generated) == 6
        assert report.goodput_tokens == 6

    def test_stop_flag_snapshots_and_exits(self, setup, tmp_path):
        eng = make_engine(setup)
        submit_all(eng, max_new=20)
        stops = {"n": 0}

        def stop_flag():
            stops["n"] += 1
            return stops["n"] > 4

        report = loop(eng, tmp_path, snapshot_every=100, stop_flag=stop_flag)
        assert report.interrupted
        assert latest_snapshot(str(tmp_path)) == report.steps
        fresh = make_engine(setup)
        restore_latest_snapshot(fresh, str(tmp_path))
        assert fresh.active or fresh.waiting
        while fresh.active or fresh.waiting:
            fresh.step()
        assert len(fresh.completed) == 3


def _kill_steps(injector, config, error, seed):
    inj = injector(config(seed=seed, kill_prob=0.3, max_kills=10))
    out = []
    for s in range(50):
        try:
            inj.fault_injector(s)
        except error:
            out.append(s)
    return out


def _deadline_requests(eng, request):
    eng.submit(request(rid=0, prompt=np.arange(3, dtype=np.int32) + 1, max_new_tokens=6,
                       deadline_s=1000.0))
    eng.submit(request(rid=1, prompt=np.arange(4, dtype=np.int32) + 1, max_new_tokens=50,
                       deadline_s=6.0))
    eng.submit(request(rid=2, prompt=np.arange(5, dtype=np.int32) + 1, max_new_tokens=6,
                       deadline_s=-1.0))


# ---------------------------------------------------------------------------
# degraded-fabric replanning (the JAX TestDegradedReplan, on the port)
# ---------------------------------------------------------------------------


class TestDegradedReplan:
    def test_degraded_wire_changes_merge_decision(self):
        cfg = get_config("tinyllama-1.1b")
        plan = build_serve_plan(cfg, param_shapes(cfg), "tpu_v5e", {"model": 8}, batch_rows=64)
        assert len(plan.schedule.groups) > 1
        degraded = AllReduceModel(a=plan.model.a * 50, b=plan.model.b * 10, name="degraded")
        new = rebuild_serve_plan(plan, degraded)
        assert len(new.schedule.groups) < len(plan.schedule.groups)
        assert new.predicted_step_time() > plan.predicted_step_time()
        assert new.provenance["refit"] == "degraded_fabric"
        # the JAX package's plans make the same decision at the same constants
        from repro.core.comm_model import AllReduceModel as JaxAllReduceModel
        from repro.planning import rebuild_serve_plan as jax_rebuild

        jcfg = jax_get_config("tinyllama-1.1b")
        jplan = jax_build_serve_plan(jcfg, param_specs(jcfg), "tpu_v5e", {"model": 8},
                                     batch_rows=64)
        jnew = jax_rebuild(jplan, JaxAllReduceModel(a=jplan.model.a * 50,
                                                    b=jplan.model.b * 10, name="degraded"))
        assert [list(g) for g in new.schedule.groups] == [list(g) for g in jnew.schedule.groups]

    def test_refit_serve_fit_recovers_constants(self):
        truth = AllReduceModel(a=5e-4, b=2e-9, name="truth")
        fit = refit_serve_fit(lambda nb: truth(nb))
        assert fit.a == pytest.approx(truth.a, rel=1e-6)
        assert fit.b == pytest.approx(truth.b, rel=1e-6)

    def test_loop_replans_under_sustained_slowdown(self, setup, tmp_path):
        _, tcfg, _, _ = setup
        plan = build_serve_plan(tcfg, param_shapes(tcfg), "tpu_v5e", {"model": 8}, batch_rows=4)
        eng = make_engine(setup, slots=2, max_seq=128, plan=plan)
        for rid in range(2):
            eng.submit(Request(rid=rid, prompt=np.arange(4, dtype=np.int32) + 1,
                               max_new_tokens=40))
        chaos = ChaosInjector(ChaosConfig(seed=3, slow_factor=30.0, slow_after=12))
        report = loop(eng, tmp_path, snapshot_every=50, chaos=chaos,
                      straggler=StragglerMonitor(window=16, factor=2.0, patience=2))
        assert report.replans >= 1
        assert eng.plan.model.a == pytest.approx(plan.model.a * 30)
        assert eng.plan.predicted_step_time() > plan.predicted_step_time()


# ---------------------------------------------------------------------------
# cross-package: the port's loop against the JAX loop
# ---------------------------------------------------------------------------

COUNTERS = ("steps", "restarts", "replans", "snapshots", "snapshot_fallbacks", "shed", "expired",
            "goodput_tokens", "interrupted", "recovery_times_s", "wall_s")

SCENARIOS = {
    # name: (ChaosConfig fields, loop options, requests, with a plan)
    "kill": (dict(seed=7, kill_at=(4,)), dict(snapshot_every=2), "plain", False),
    "corrupt": (dict(seed=7, kill_at=(5,), corrupt_snapshot_at=4, partial_write_at=4),
                dict(snapshot_every=2), "plain", False),
    "kill_prob": (dict(seed=5, kill_prob=0.3, max_kills=3), dict(snapshot_every=2), "plain",
                  False),
    "kill_every": (dict(seed=1, kill_every=3, max_kills=2, corrupt_snapshot_at=2),
                   dict(snapshot_every=2, max_restarts=2), "plain", False),
    "deadlines": (None, dict(snapshot_every=100), "deadlines", False),
    "slowdown": (dict(seed=3, slow_factor=30.0, slow_after=12), dict(snapshot_every=50),
                 "long", True),
}


def _run_both(s, tmp_path, chaos_kw, loop_kw, reqs, with_plan):
    """The JAX loop, then the port's, on the same bridged weights (``s``),
    requests, chaos and clock: the two ``ServeReport``s."""
    jcfg, tcfg, _, _ = s
    out = []
    for side in ("jax", "torch"):
        if side == "jax":
            plan = (jax_build_serve_plan(jcfg, param_specs(jcfg), "tpu_v5e", {"model": 8},
                                         batch_rows=4) if with_plan else None)
            eng = make_jax_engine(s, max_seq=128 if reqs == "long" else 64, plan=plan)
            cfg_t, inj_t, req_t, mon_t, run = (JaxChaosConfig, JaxChaosInjector, JaxRequest,
                                               JaxStragglerMonitor, jax_resilient_serve_loop)
        else:
            plan = (build_serve_plan(tcfg, param_shapes(tcfg), "tpu_v5e", {"model": 8},
                                     batch_rows=4) if with_plan else None)
            eng = make_engine(s, max_seq=128 if reqs == "long" else 64, plan=plan)
            cfg_t, inj_t, req_t, mon_t, run = (ChaosConfig, ChaosInjector, Request,
                                               StragglerMonitor, resilient_serve_loop)
        if reqs == "deadlines":
            _deadline_requests(eng, req_t)
        elif reqs == "long":
            for rid in range(2):
                eng.submit(req_t(rid=rid, prompt=np.arange(4, dtype=np.int32) + 1,
                                 max_new_tokens=40))
        else:
            rng = np.random.default_rng(4)
            for rid in range(3):
                eng.submit(req_t(rid=rid, prompt=rng.integers(0, jcfg.vocab, size=5 + 3 * rid,
                                                              dtype=np.int32),
                                 max_new_tokens=7))
        report = run(eng, snapshot_dir=str(tmp_path / side), backoff_base_s=0.0,
                     clock=FakeClock(0.25),
                     chaos=None if chaos_kw is None else inj_t(cfg_t(**chaos_kw)),
                     straggler=mon_t(window=16, factor=2.0, patience=2) if with_plan else None,
                     **loop_kw)
        out.append(report)
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_resilient_loop_matches_jax(setup, tmp_path, name):
    chaos_kw, loop_kw, reqs, with_plan = SCENARIOS[name]
    jrep, trep = _run_both(setup, tmp_path, chaos_kw, loop_kw, reqs, with_plan)
    assert tokens(trep) == {r.rid: list(r.generated) for r in jrep.completed}
    assert [(r.rid, r.shed, r.expired) for r in trep.completed] == \
        [(r.rid, r.shed, r.expired) for r in jrep.completed]
    for key in COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    if chaos_kw is not None and "kill_at" in chaos_kw:
        assert trep.restarts >= 1
    if name == "corrupt":
        assert trep.snapshot_fallbacks >= 1
    if name == "slowdown":
        assert trep.replans >= 1


def test_chaos_draws_match_jax():
    """The injectors draw the same kill steps from one seed, and
    ``for_replica`` derives the same seeds."""
    for seed in (0, 5, 6):
        assert _kill_steps(ChaosInjector, ChaosConfig, ChaosError, seed) == \
            _kill_steps(JaxChaosInjector, JaxChaosConfig, JaxChaosError, seed)
    fleet, jfleet = ChaosConfig(seed=42, kill_at=(3,)), JaxChaosConfig(seed=42, kill_at=(3,))
    assert [fleet.for_replica(i).seed for i in range(4)] == \
        [jfleet.for_replica(i).seed for i in range(4)]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_recurrent_kill_and_restore_match(arch, tmp_path):
    """The recurrent states (``(conv, h)``, the token shifts and the WKV
    state) and the ring's ``kpos`` survive a snapshot: a killed and restored
    run equals the unbroken one and the JAX loop's."""
    s = _bridged(arch)
    unbroken = make_engine(s)
    rng = np.random.default_rng(4)
    for rid in range(3):
        unbroken.submit(Request(rid=rid, prompt=rng.integers(0, s[0].vocab, size=5 + 3 * rid,
                                                             dtype=np.int32), max_new_tokens=7))
    want = {r.rid: r.generated for r in unbroken.run_to_completion()}
    jrep, trep = _run_both(s, tmp_path, dict(seed=7, kill_at=(3, 6)), dict(snapshot_every=2),
                           "plain", False)
    assert trep.restarts == 2
    assert tokens(trep) == want
    assert tokens(trep) == {r.rid: list(r.generated) for r in jrep.completed}


# ---------------------------------------------------------------------------
# port only
# ---------------------------------------------------------------------------


def test_flipped_byte_is_rejected_before_the_engine(setup, tmp_path):
    """One byte flipped in ``tensors.bin``: ``load_snapshot`` raises on the
    CRC-32 check and the engine's tensors are untouched; the restore falls
    back to the older snapshot."""
    eng = make_engine(setup)
    submit_all(eng)
    eng.step()
    save_snapshot(eng, str(tmp_path), 1)
    eng.step()
    save_snapshot(eng, str(tmp_path), 2)
    data = pathlib.Path(tmp_path) / "step_00000002" / "tensors.bin"
    raw = bytearray(data.read_bytes())
    raw[len(raw) // 3] ^= 0x01
    data.write_bytes(bytes(raw))

    target = make_engine(setup)
    submit_all(target, n=1)
    target.step()
    before = [t.clone() for t in tree_leaves(target._state)]
    with pytest.raises(ValueError, match="CRC-32"):
        load_snapshot(str(tmp_path), 2, target)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(target._state)))
    step, skipped = restore_latest_snapshot(target, str(tmp_path))
    assert (step, skipped) == (1, 1)


def test_restore_keeps_every_tensor(setup, tmp_path):
    """A restore copies into the engine's tensors (what a captured graph
    replays over): every state tensor keeps its storage."""
    eng = make_engine(setup)
    submit_all(eng)
    for _ in range(2):
        eng.step()
    save_snapshot(eng, str(tmp_path), 2)
    fresh = make_engine(setup)
    ptrs = [t.data_ptr() for t in tree_leaves(fresh._state)]
    restore_latest_snapshot(fresh, str(tmp_path))
    assert [t.data_ptr() for t in tree_leaves(fresh._state)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(fresh._state),
                                                 tree_leaves(eng._state)))


def test_seeded_sampling_survives_kill_and_restore(setup, tmp_path):
    """Both generators' states ride in the snapshot: a ``gumbel_sampler``
    run killed twice repeats the unbroken run on the same seed."""
    def engine():
        return make_engine(setup, sample=gumbel_sampler(1.0), sample_seed=2)

    unbroken = engine()
    submit_all(unbroken, n=4, max_new=8)
    want = {r.rid: r.generated for r in unbroken.run_to_completion()}
    eng = engine()
    submit_all(eng, n=4, max_new=8)
    report = loop(eng, tmp_path, snapshot_every=3,
                  chaos=ChaosInjector(ChaosConfig(kill_at=(5, 10))))
    assert report.restarts == 2
    assert tokens(report) == want
    assert want != {r.rid: r.generated for r in _greedy_run(setup)}


def _greedy_run(setup):
    eng = make_engine(setup)
    submit_all(eng, n=4, max_new=8)
    return eng.run_to_completion()
