"""The serving fleet of the port (``repro_torch.serving.fleet``) held
against the JAX package's, on reduced TinyLlama with f32 weights bridged by
``from_jax_params``.

* Every test of the JAX ``tests/test_fleet.py`` on the port: seeded load
  generation, per-replica chaos domains, fault-free runs, failover that
  keeps partial tokens, determinism, fleet-wide shedding, elastic
  scale-up, the watchdog's pricing, and the engine's drain / resume seams.
  Every fleet runs on an injected clock (``FakeClock``): the JAX
  ``test_failover_is_deterministic`` reads ``time.monotonic`` and is flaky
  under load.
* Cross-package: ``FleetController.run`` of both packages on the same
  weights, load, chaos and clock gives equal tokens per request, equal
  ``FleetReport`` counters and the same ``replica_id`` / ``retries`` /
  deadline for every request; ``LoadGenerator`` gives the same arrivals,
  prompts and deadlines.  Among the cases: a replica restored to the
  snapshot its driver took before any request was routed to it, which
  loses those requests in both packages (ROADMAP C).
* ``python -m repro_torch.launch.serve_fleet --device cpu`` completes every
  request with no failover token mismatch under ``--chaos-kill-at``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as jax_get_reduced
from repro.launch.specs import param_specs
from repro.models.transformer import init_params
from repro.planning import build_serve_plan as jax_build_serve_plan
from repro.serving import ChaosConfig as JaxChaosConfig
from repro.serving import FleetConfig as JaxFleetConfig
from repro.serving import FleetController as JaxFleetController
from repro.serving import LoadGenerator as JaxLoadGenerator
from repro.serving import LoadSpec as JaxLoadSpec
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_reduced
from repro_torch.launch import serve_fleet
from repro_torch.models import Transformer, from_jax_params, load_arrays, param_shapes
from repro_torch.planning import build_serve_plan
from repro_torch.serving import (
    ChaosConfig,
    FleetConfig,
    FleetController,
    FleetWatchdog,
    LoadGenerator,
    LoadSpec,
    Request,
    ServingEngine,
)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_reduced("tinyllama-1.1b", param_dtype=jnp.float32)
    tcfg = get_reduced("tinyllama-1.1b", param_dtype=torch.float32)
    params = init_params(jax.random.PRNGKey(0), jcfg)
    model = Transformer(tcfg, device="cpu", seed=None)
    load_arrays(model, from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    plan = build_serve_plan(tcfg, param_shapes(tcfg), "tpu_v5e", {"model": 8}, batch_rows=4)
    jplan = jax_build_serve_plan(jcfg, param_specs(jcfg), "tpu_v5e", {"model": 8}, batch_rows=4)
    return {"torch": (tcfg, model, plan), "jax": (jcfg, params, jplan)}


class FakeClock:
    """Deterministic fleet clock: advances a fixed amount per call."""

    def __init__(self, dt=0.25):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


SIDES = {
    "torch": (ServingEngine, FleetController, FleetConfig, ChaosConfig, LoadGenerator, LoadSpec),
    "jax": (JaxServingEngine, JaxFleetController, JaxFleetConfig, JaxChaosConfig,
            JaxLoadGenerator, JaxLoadSpec),
}


def make_fleet(setup, tmp_path, *, side="torch", replicas=2, chaos=None, chaos_replicas=None,
               **cfg_kw):
    cfg, weights, plan = setup[side]
    engine_t, fleet_t, config_t, chaos_t, _, _ = SIDES[side]
    cfg_kw.setdefault("snapshot_every", 50)
    cfg_kw.setdefault("max_restores", 0)
    return fleet_t(
        engine_factory=lambda rid: engine_t(cfg, weights, slots=2, max_seq=64, plan=plan),
        config=config_t(replicas=replicas, backoff_base_s=0.0, idle_sleep_s=0.0, **cfg_kw),
        snapshot_root=str(tmp_path),
        clock=FakeClock(),
        chaos=None if chaos is None else chaos_t(**chaos),
        chaos_replicas=chaos_replicas,
    )


def fast_load(n=4, max_new=5, side="torch", **kw):
    # arrivals all effectively immediate, so no run waits
    _, _, _, _, gen_t, spec_t = SIDES[side]
    kw.setdefault("rate_rps", 1e6)
    return gen_t(spec_t(n_requests=n, prompt_len=4, max_new_tokens=max_new, **kw))


# ---------------------------------------------------------------------------
# LoadGenerator
# ---------------------------------------------------------------------------


class TestLoadGenerator:
    def test_same_seed_same_traffic(self):
        a = LoadGenerator(LoadSpec(n_requests=6, seed=7))
        b = LoadGenerator(LoadSpec(n_requests=6, seed=7))
        for (ta, ra), (tb, rb) in zip(a.due(1e9), b.due(1e9)):
            assert ta == tb
            assert np.array_equal(ra.prompt, rb.prompt)

    def test_due_respects_arrival_order(self):
        gen = LoadGenerator(LoadSpec(n_requests=8, kind="trace", trace_arrivals_s=(0.0, 1.0, 2.0)))
        first = gen.due(1.5)
        assert [off for off, _ in first] == sorted(off for off, _ in first)
        assert all(off <= 1.5 for off, _ in first)
        assert not gen.exhausted
        assert gen.next_arrival_s > 1.5
        rest = gen.due(1e9)
        assert len(first) + len(rest) == 8
        assert gen.exhausted

    def test_trace_cycles_past_its_length(self):
        gen = LoadGenerator(LoadSpec(n_requests=5, kind="trace", trace_arrivals_s=(0.0, 0.5)))
        offs = [off for off, _ in gen.due(1e9)]
        assert len(offs) == 5
        assert offs == sorted(offs)
        assert len(set(offs)) == 5  # cycling shifts repeats by a period


@pytest.mark.parametrize("spec", [
    dict(n_requests=9, seed=7, rate_rps=50.0, deadline_s=0.5, vocab=32000),
    dict(n_requests=7, kind="trace", trace_arrivals_s=(0.0, 0.3, 1.1), prompt_len=12, seed=3),
], ids=["poisson", "trace"])
def test_load_generator_matches_jax(spec):
    got = LoadGenerator(LoadSpec(**spec))
    want = JaxLoadGenerator(JaxLoadSpec(**spec))
    assert len(got) == len(want)
    for (tg, rg), (tw, rw) in zip(got.due(1e9), want.due(1e9)):
        assert tg == tw and rg.rid == rw.rid and rg.max_new_tokens == rw.max_new_tokens
        assert np.array_equal(rg.prompt, rw.prompt) and rg.prompt.dtype == rw.prompt.dtype
    assert got.spec.deadline_s == want.spec.deadline_s


# ---------------------------------------------------------------------------
# per-replica chaos domains
# ---------------------------------------------------------------------------


class TestForReplica:
    def test_deterministic_and_distinct(self):
        fleet = ChaosConfig(seed=42, kill_at=(3,), slow_factor=2.0)
        seeds = [fleet.for_replica(i).seed for i in range(4)]
        assert seeds == [fleet.for_replica(i).seed for i in range(4)]
        assert len(set(seeds)) == 4

    def test_schedule_fields_shared(self):
        fleet = ChaosConfig(seed=1, kill_at=(3,), kill_prob=0.25, slow_factor=2.0, slow_after=5)
        derived = fleet.for_replica(2)
        assert derived.kill_at == fleet.kill_at
        assert derived.kill_prob == fleet.kill_prob
        assert derived.slow_factor == fleet.slow_factor
        assert derived.slow_after == fleet.slow_after
        assert derived.seed != fleet.seed


# ---------------------------------------------------------------------------
# fleet runs
# ---------------------------------------------------------------------------


class TestFleet:
    def test_fault_free_completes_everything(self, setup, tmp_path):
        fleet = make_fleet(setup, tmp_path, replicas=2)
        report = fleet.run(fast_load(n=5, max_new=5))
        assert report.offered == 5
        assert len(report.completed) == 5
        assert report.shed == 0 and report.expired == 0
        assert report.goodput_tokens == 5 * 5
        assert report.replica_deaths == 0
        assert report.failover_token_mismatches == 0
        assert len(report.latencies_s) == 5
        assert report.latency_percentile(99) >= report.latency_percentile(50)
        assert {r.replica_id for r in report.completed.values()} == {0, 1}

    def test_failover_preserves_partial_tokens(self, setup, tmp_path):
        fleet = make_fleet(setup, tmp_path, replicas=2, chaos=dict(kill_at=(2,)),
                           chaos_replicas=(0,))
        report = fleet.run(fast_load(n=4, max_new=8))
        assert report.replica_deaths == 1
        assert report.failovers >= 1
        assert len(report.completed) == 4
        assert report.failover_token_mismatches == 0
        assert report.goodput_tokens == 4 * 8  # never counted twice
        moved = [r for r in report.completed.values() if r.retries > 0]
        assert moved
        assert all(r.replica_id == 1 for r in moved)
        assert all(len(r.generated) == 8 for r in moved)

    def test_failover_is_deterministic(self, setup, tmp_path):
        out = []
        for sub in ("a", "b"):
            fleet = make_fleet(setup, tmp_path / sub, replicas=2,
                               chaos=dict(seed=5, kill_at=(2,)), chaos_replicas=(0,))
            report = fleet.run(fast_load(n=4, max_new=6, seed=3))
            out.append({rid: tuple(r.generated) for rid, r in sorted(report.completed.items())})
        assert out[0] == out[1]

    def test_sheds_when_no_replica_meets_deadline(self, setup, tmp_path):
        fleet = make_fleet(setup, tmp_path, replicas=2)
        report = fleet.run(fast_load(n=3, max_new=64, deadline_s=1e-9))
        assert report.shed == 3
        assert report.goodput_tokens == 0
        assert all(r.shed for r in report.completed.values())
        assert report.latency_percentile(99) == 0.0

    def test_elastic_scale_up_under_backlog(self, setup, tmp_path):
        fleet = make_fleet(setup, tmp_path, replicas=1, elastic=True, max_replicas=2,
                           scale_up_backlog_s=0.0)
        report = fleet.run(fast_load(n=6, max_new=6))
        assert report.scale_ups >= 1
        assert len(fleet.replicas) == 2
        assert report.scale_decisions
        d = report.scale_decisions[0]
        assert d["action"] == "scale_up"
        assert d["drain_s_after"] < d["drain_s_before"]
        assert len(report.completed) == 6
        assert report.failover_token_mismatches == 0
        scaled = next(r for r in report.replicas if r["rid"] == 1)
        assert scaled["steps"] > 0
        assert {r.replica_id for r in report.completed.values()} == {0, 1}


# ---------------------------------------------------------------------------
# watchdog pricing (unit level)
# ---------------------------------------------------------------------------


class _FakePlan:
    def capacity_tok_per_s(self, rows):
        return float(rows) * 100.0


class TestFleetWatchdog:
    def test_scale_up_priced_by_plan(self):
        dog = FleetWatchdog(scale_up_backlog_s=0.5)
        act = dog.assess(round_idx=0, backlog_tokens=1000, n_alive=2, plan=_FakePlan(), slots=4)
        assert act == "scale_up"
        d = dog.decisions[0]
        assert d["capacity_tok_per_s_per_replica"] == 400.0
        assert d["drain_s_before"] == pytest.approx(1000 / 800)
        assert d["drain_s_after"] == pytest.approx(1000 / 1200)

    def test_cooldown_blocks_thrash(self):
        dog = FleetWatchdog(scale_up_backlog_s=0.5, cooldown_rounds=3)
        assert dog.assess(round_idx=0, backlog_tokens=1000, n_alive=1, plan=_FakePlan(),
                          slots=4) == "scale_up"
        for i in range(1, 3):
            assert dog.assess(round_idx=i, backlog_tokens=1000, n_alive=1, plan=_FakePlan(),
                              slots=4) is None
        assert dog.assess(round_idx=3, backlog_tokens=1000, n_alive=1, plan=_FakePlan(),
                          slots=4) == "scale_up"

    def test_scale_down_after_idle(self):
        dog = FleetWatchdog(scale_down_idle_rounds=2, cooldown_rounds=0)
        assert dog.assess(round_idx=0, backlog_tokens=0, n_alive=2, plan=_FakePlan(),
                          slots=4) is None
        assert dog.assess(round_idx=1, backlog_tokens=0, n_alive=2, plan=_FakePlan(),
                          slots=4) == "scale_down"
        dog2 = FleetWatchdog(scale_down_idle_rounds=1, cooldown_rounds=0)
        assert dog2.assess(round_idx=0, backlog_tokens=0, n_alive=1, plan=_FakePlan(),
                           slots=4) is None

    def test_unpriced_fleet_never_scales(self):
        dog = FleetWatchdog(scale_up_backlog_s=0.0)
        assert dog.assess(round_idx=0, backlog_tokens=10_000, n_alive=1, plan=None,
                          slots=4) is None
        assert not dog.decisions


# ---------------------------------------------------------------------------
# engine failover seams (drain + resume re-admission)
# ---------------------------------------------------------------------------


class TestEngineFailoverSeams:
    def test_drain_requests_empties_engine(self, setup):
        cfg, model, plan = setup["torch"]
        eng = ServingEngine(cfg, model, slots=2, max_seq=64, plan=plan)
        for rid in range(3):
            eng.submit(Request(rid=rid, prompt=np.arange(4, dtype=np.int32) + 1,
                               max_new_tokens=6))
        for _ in range(2):
            eng.step()
        reqs = eng.drain_requests()
        assert len(reqs) == 3
        assert not eng.active and not eng.waiting
        assert not any(r.done for r in reqs)
        assert any(r.generated for r in reqs)

    def test_resume_admission_preserves_prefix(self, setup):
        cfg, model, plan = setup["torch"]
        prompt = np.arange(5, dtype=np.int32) + 1
        a = ServingEngine(cfg, model, slots=2, max_seq=64)
        a.submit(Request(rid=0, prompt=prompt, max_new_tokens=8))
        for _ in range(3):
            a.step()
        (req,) = a.drain_requests()
        prefix = list(req.generated)
        assert 0 < len(prefix) < 8
        outs = []
        for _ in range(2):
            b = ServingEngine(cfg, model, slots=2, max_seq=64)
            b.submit(dataclasses.replace(req, generated=list(prefix), done=False,
                                         retries=req.retries + 1))
            while b.active or b.waiting:
                b.step()
            outs.append(list(b.completed[0].generated))
        assert outs[0][: len(prefix)] == prefix
        assert len(outs[0]) == 8
        assert outs[0] == outs[1]
        assert b.prefills == 1  # the resumed request's one re-prefill


# ---------------------------------------------------------------------------
# cross-package: the port's fleet against the JAX fleet
# ---------------------------------------------------------------------------

FLEET_CASES = {
    # name: (fleet options, chaos, chaos replicas, load options)
    "fault_free": (dict(replicas=2), None, None, dict(n=5, max_new=5)),
    "failover": (dict(replicas=2), dict(seed=5, kill_at=(2,)), (0,), dict(n=4, max_new=8)),
    "failover_3": (dict(replicas=3), dict(seed=1, kill_at=(3,)), (0,),
                   dict(n=7, max_new=6, seed=2)),
    "shed": (dict(replicas=2), None, None, dict(n=3, max_new=64, deadline_s=1e-9)),
    "deadline_expire": (dict(replicas=2), None, None, dict(n=6, max_new=20, deadline_s=2.0)),
    "elastic": (dict(replicas=1, elastic=True, max_replicas=2, scale_up_backlog_s=0.0), None,
                None, dict(n=6, max_new=6)),
    # a replica killed before its first cadence snapshot restores to the empty
    # engine its driver snapshotted at construction: both packages drop the
    # requests that had been routed to it
    "restore_to_empty": (dict(replicas=2, max_restores=1), dict(kill_at=(2,)), (0,),
                         dict(n=5, max_new=5)),
}

FLEET_COUNTERS = ("offered", "shed", "expired", "failovers", "failover_token_mismatches",
                  "replica_deaths", "restores", "snapshots", "scale_ups", "scale_downs",
                  "goodput_tokens", "rounds", "replicas", "latencies_s", "wall_s")


@pytest.mark.parametrize("name", list(FLEET_CASES))
def test_fleet_matches_jax(setup, tmp_path, name):
    fleet_kw, chaos, chaos_replicas, load_kw = FLEET_CASES[name]
    reports = {}
    for side in ("jax", "torch"):
        fleet = make_fleet(setup, tmp_path / side, side=side, chaos=chaos,
                           chaos_replicas=chaos_replicas, **fleet_kw)
        reports[side] = fleet.run(fast_load(side=side, **load_kw))
    got, want = reports["torch"], reports["jax"]
    per_request = lambda rep: {rid: (list(r.generated), r.replica_id, r.retries, r.shed,
                                     r.expired, r.deadline_s)
                               for rid, r in rep.completed.items()}
    assert per_request(got) == per_request(want)
    for key in FLEET_COUNTERS:
        assert getattr(got, key) == getattr(want, key), key
    assert got.summary() == want.summary()
    if chaos is not None:
        assert got.replica_deaths + got.restores >= 1
    if name == "restore_to_empty":
        assert got.offered > len(got.completed)  # the reference's loss, reproduced


def test_serve_fleet_cli_on_cpu(tmp_path, capsys):
    """The launcher on the CPU: replica 0 killed at its step 2 with no
    restore budget; every request completes, with no token mismatch."""
    res = serve_fleet.run(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
                           "--replicas", "2", "--requests", "6", "--prompt-len", "8",
                           "--tokens", "6", "--rate", "1e6", "--chaos-kill-at", "2",
                           "--chaos-replicas", "0", "--max-restores", "0",
                           "--snapshot-root", str(tmp_path)])
    s = res.report.summary()
    assert s["completed"] == 6 and s["failover_token_mismatches"] == 0
    assert s["replica_deaths"] == 1 and s["failovers"] >= 1 and s["goodput_tokens"] == 36
    out = capsys.readouterr().out
    assert "[fleet] offered=6 completed=6" in out and "token_mismatches=0" in out
    assert "serve_plan[mg_wfbp|gpu_nccl|all_gather]" in out
