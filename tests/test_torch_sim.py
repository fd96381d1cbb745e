"""The what-if simulator of the port (``repro_torch.sim``,
``repro_torch.configs.cnn_profiles``) held against the JAX package's.

* Every case of the JAX ``tests/test_sim.py`` on the port: the event core,
  ``ClusterSpec`` geometry, the DES == ``core.timeline.evaluate``
  invariant, stragglers, elastic and serve replay, the hierarchical
  fabrics, calibration, the paper's ordering and the ``SimReport``.
* Cross-package, with no tolerance: the event order and its errors,
  ``ClusterSpec`` JSON bytes and its all-reduce ``(a, b)`` on every fabric,
  the straggler draw, the CNN profiles layer by layer, each simulated
  iteration field by field, the elastic train replay, the serve replays,
  both calibration reports, and the ``SimReport`` of ``benchmarks/run.py``'s
  what-if sweep byte for byte (its rows also equal the committed
  ``BENCH_sim.json``'s).

The simulator touches no device, so nothing here needs the card.
"""

import dataclasses
import json

import pytest

import repro.sim as jsim
import repro_torch.sim as tsim
from _env import REPO_ROOT
from _torch_registry import pristine_policy_registries  # noqa: F401 (autouse fixture)
from repro.configs import cnn_profiles as jcnn
from repro.core import timeline as jtimeline
from repro.core.cost_model import K80_CALIBRATED as JAX_K80
from repro.planning.registry import build_schedule as jax_build_schedule
from repro.serving.fleet import LoadSpec as JaxLoadSpec
from repro_torch.configs import cnn_profiles
from repro_torch.configs.cnn_profiles import cnn_layer_costs
from repro_torch.core.comm_model import binary_tree
from repro_torch.core.cost_model import K80_CALIBRATED
from repro_torch.core.timeline import evaluate
from repro_torch.fabric import Collective, available_fabrics, get_fabric
from repro_torch.planning.registry import build_schedule
from repro_torch.serving.fleet import LoadSpec
from repro_torch.sim import (
    MAX_HOSTS,
    ClusterEvent,
    ClusterSpec,
    EventQueue,
    SimReport,
    calibrate_serve,
    calibrate_train,
    replay_serve,
    replay_train,
    row_from_replay,
    simulate_train_iteration,
)

POLICIES = ("synceasgd", "wfbp", "mg_wfbp")
WHATIF_FABRICS = ("paper_10gbe", "tree_10gbe", "pipeline_10gbe", "tpu_v5e_tree_dcn")
BENCH_SIM = REPO_ROOT / "benchmarks" / "results" / "BENCH_sim.json"


def _paper_cell(arch="googlenet", batch=64, n=8):
    """(costs, ar_model) of one paper-cluster cell."""
    costs = cnn_layer_costs(arch, batch)
    ar = ClusterSpec(n_hosts=n, fabric="paper_10gbe").ar_model()
    return costs, ar


def _jax_paper_cell(arch="googlenet", batch=64, n=8):
    costs = jcnn.cnn_layer_costs(arch, batch)
    ar = jsim.ClusterSpec(n_hosts=n, fabric="paper_10gbe").ar_model()
    return costs, ar


# ---------------------------------------------------------------------------
# The JAX tests/test_sim.py cases, on the port
# ---------------------------------------------------------------------------


class TestEventQueue:
    def test_orders_by_time_then_insertion(self):
        q = EventQueue()
        q.push(2.0, "late")
        q.push(1.0, "tie_first", tag=1)
        q.push(1.0, "tie_second", tag=2)
        kinds = [q.pop().kind for _ in range(3)]
        assert kinds == ["tie_first", "tie_second", "late"]
        assert (q.pushed, q.popped) == (3, 3)

    def test_negative_time_rejected(self):
        with pytest.raises(ValueError, match="negative"):
            EventQueue().push(-1e-9, "bad")

    def test_empty_pop_raises(self):
        with pytest.raises(IndexError):
            EventQueue().pop()

    def test_time_regression_is_a_bug_not_a_race(self):
        q = EventQueue()
        q.push(1.0, "a")
        q.pop()
        q.push(0.5, "past")
        with pytest.raises(RuntimeError, match="before now"):
            q.pop()


class TestClusterSpec:
    def test_flat_and_two_tier_axes(self):
        flat = ClusterSpec(n_hosts=8)
        assert flat.axis_sizes() == {"data": 8}
        tiered = ClusterSpec(n_hosts=64, ici_size=16)
        assert tiered.axis_sizes() == {"data": 16, "pod": 4}
        # a shrink below one domain collapses back to a flat fast tier
        assert tiered.axis_sizes(12) == {"data": 12}

    def test_bench_geometry_prices_like_the_committed_sweep(self):
        from repro_torch.fabric.presets import tpu_psum_model

        got = ClusterSpec(n_hosts=32, ici_size=16, fabric="tpu_v5e").ar_model()
        ref = tpu_psum_model({"pod": 2, "data": 16})
        assert (got.a, got.b) == (ref.a, ref.b)

    def test_json_round_trip_exact(self):
        spec = ClusterSpec(
            n_hosts=64, ici_size=16, fabric="pipeline_10gbe",
            straggler_spread=0.3, seed=7,
            events=(ClusterEvent(at_iter=2, kind="kill", count=4),),
        )
        rt = ClusterSpec.from_json(spec.to_json())
        assert rt == spec
        assert rt.to_json() == spec.to_json()

    def test_validation(self):
        with pytest.raises(ValueError):
            ClusterSpec(n_hosts=0)
        with pytest.raises(ValueError):
            ClusterSpec(n_hosts=MAX_HOSTS + 1)
        with pytest.raises(ValueError, match="kind"):
            ClusterEvent(at_iter=0, kind="explode")
        with pytest.raises(ValueError):
            ClusterEvent(at_iter=-1, kind="kill")

    def test_straggler_draw_seeded_and_stable_across_shrink(self):
        spec = ClusterSpec(n_hosts=8, straggler_spread=0.5, seed=3)
        m8 = spec.straggler_multipliers()
        assert m8 == spec.straggler_multipliers()
        assert all(1.0 <= m <= 1.5 for m in m8)
        assert len(set(m8)) > 1
        assert spec.straggler_multipliers(5) == m8[:5]
        assert ClusterSpec(n_hosts=8).straggler_multipliers() == (1.0,) * 8

    def test_alive_after_applies_events_in_order(self):
        spec = ClusterSpec(
            n_hosts=16,
            events=(ClusterEvent(at_iter=1, kind="shrink", count=8),
                    ClusterEvent(at_iter=3, kind="grow", count=4),
                    ClusterEvent(at_iter=5, kind="kill", count=2)),
        )
        assert spec.alive_after(0) == (16, 0)
        assert spec.alive_after(1) == (8, 0)
        assert spec.alive_after(3) == (12, 0)
        assert spec.alive_after(5) == (10, 2)
        doomed = ClusterSpec(
            n_hosts=2, events=(ClusterEvent(at_iter=0, kind="kill", count=99),))
        assert doomed.alive_after(0) == (1, 99)


class TestExactnessInvariant:
    """With homogeneous multipliers the port's DES is the port's
    ``evaluate``, float for float, trace row by trace row."""

    @pytest.mark.parametrize("policy", [*POLICIES, "dp_optimal"])
    def test_des_matches_evaluate_bit_for_bit(self, policy):
        costs, ar = _paper_cell()
        sched = build_schedule(policy, list(costs), ar, hw=K80_CALIBRATED)
        ref = evaluate(list(sched.groups), list(costs), ar, hw=K80_CALIBRATED)
        sim = simulate_train_iteration(sched.groups, list(costs), ar,
                                       hw=K80_CALIBRATED, multipliers=(1.0,) * 8)
        assert sim.t_iter == ref.t_iter  # == on floats, deliberately
        assert sim.groups == tuple(ref.groups)
        assert sim.n_events == 8 * len(sched.groups)

    def test_serialized_mode_matches_evaluate(self):
        costs, ar = _paper_cell()
        sched = build_schedule("mg_wfbp", list(costs), ar, hw=K80_CALIBRATED,
                               mode="serialized")
        ref = evaluate(list(sched.groups), list(costs), ar, hw=K80_CALIBRATED,
                       mode="serialized")
        sim = simulate_train_iteration(sched.groups, list(costs), ar, hw=K80_CALIBRATED,
                                       multipliers=(1.0,) * 4, mode="serialized")
        assert sim.t_iter == ref.t_iter and sim.groups == tuple(ref.groups)

    def test_multiplier_validation(self):
        costs, ar = _paper_cell()
        with pytest.raises(ValueError, match="at least one"):
            simulate_train_iteration([(1, len(costs))], list(costs), ar,
                                     hw=K80_CALIBRATED, multipliers=())
        with pytest.raises(ValueError, match=">= 1"):
            simulate_train_iteration([(1, len(costs))], list(costs), ar,
                                     hw=K80_CALIBRATED, multipliers=(0.5,))


class TestStragglers:
    def test_slowest_host_sets_the_compute_wall(self):
        costs, ar = _paper_cell()
        sched = build_schedule("mg_wfbp", list(costs), ar, hw=K80_CALIBRATED)
        base = simulate_train_iteration(sched.groups, list(costs), ar, hw=K80_CALIBRATED)
        slow = simulate_train_iteration(sched.groups, list(costs), ar, hw=K80_CALIBRATED,
                                        multipliers=(1.0, 1.0, 1.4))
        assert slow.t_compute == pytest.approx(1.4 * (base.t_f + base.t_b))
        assert slow.t_iter >= base.t_iter
        assert slow.scaling_efficiency < base.scaling_efficiency

    def test_t_iter_monotone_in_spread(self):
        costs = cnn_layer_costs("googlenet", 64)
        t = [replay_train(ClusterSpec(n_hosts=16, fabric="paper_10gbe",
                                      straggler_spread=s, seed=5),
                          list(costs), "mg_wfbp", hw=K80_CALIBRATED).mean_t_iter
             for s in (0.0, 0.25, 0.5)]
        assert t[0] <= t[1] <= t[2]


class TestElasticReplay:
    def test_transitions_reprice_and_replan(self):
        costs = cnn_layer_costs("googlenet", 64)
        spec = ClusterSpec(
            n_hosts=64, fabric="paper_10gbe",
            events=(ClusterEvent(at_iter=1, kind="shrink", count=56),
                    ClusterEvent(at_iter=3, kind="grow", count=56)),
        )
        res = replay_train(spec, list(costs), "mg_wfbp", hw=K80_CALIBRATED, n_iters=5)
        assert [r["n_alive"] for r in res.iterations] == [64, 8, 8, 64, 64]
        assert res.n_replans == 2
        assert [r["replanned"] for r in res.iterations] == [False, True, False, True, False]
        by_alive = {r["n_alive"]: r for r in res.iterations}
        assert by_alive[8]["t_iter_s"] < by_alive[64]["t_iter_s"]

    def test_kills_are_tallied(self):
        costs = cnn_layer_costs("googlenet", 64)
        spec = ClusterSpec(n_hosts=8, events=(ClusterEvent(at_iter=1, kind="kill", count=3),))
        res = replay_train(spec, list(costs), "wfbp", hw=K80_CALIBRATED, n_iters=2)
        assert res.n_kills == 3
        assert res.iterations[-1]["n_alive"] == 5


def _load(spec_cls=LoadSpec, n=8, tokens=16, deadline=None):
    return spec_cls(n_requests=n, prompt_len=1, max_new_tokens=tokens, kind="trace",
                    trace_arrivals_s=(0.0,) * n, deadline_s=deadline, seed=0)


class TestServeReplay:
    def test_deterministic_and_token_conserving(self):
        a = replay_serve(_load(), 0.01, n_replicas=2, slots=2)
        b = replay_serve(_load(), 0.01, n_replicas=2, slots=2)
        assert a == b
        assert a.completed == 8 and a.shed == a.lost == 0
        assert a.tokens_emitted == 8 * 16

    def test_slot_bound_admission(self):
        one = replay_serve(_load(), 0.01, n_replicas=1, slots=2)
        assert one.steps >= 64
        assert one.duration_s == pytest.approx(one.steps * 0.01)

    def test_kill_fails_over_with_progress_preserved(self):
        sv = replay_serve(_load(), 0.01, n_replicas=2, slots=4, kill_at_s={0: 0.035})
        assert sv.failovers >= 1
        assert sv.completed == 8 and sv.lost == 0
        assert sv.tokens_emitted <= 8 * 16
        solo = replay_serve(_load(), 0.01, n_replicas=1, slots=4)
        assert sv.duration_s >= solo.duration_s * 0.5

    def test_all_replicas_dead_loses_requests(self):
        sv = replay_serve(_load(n=4), 0.01, n_replicas=1, slots=4, kill_at_s={0: 0.005})
        assert sv.lost + sv.failovers >= 1
        assert sv.completed < 4

    def test_deadline_sheds_at_admission(self):
        sv = replay_serve(_load(deadline=1e-9), 0.01, n_replicas=2, slots=2)
        assert sv.shed == 8 and sv.completed == 0 and sv.tokens_emitted == 0

    def test_bad_step_rejected(self):
        with pytest.raises(ValueError, match="step_s"):
            replay_serve(_load(), 0.0)


class TestHierarchicalFabrics:
    def test_tree_startup_is_log_n(self):
        f = get_fabric("tree_10gbe")
        for n in (8, 64, 512):
            got = f.cost(Collective.ALL_REDUCE, {"data": n})
            ref = binary_tree(n, f.ici_alpha, 1.0 / f.ici_link_bw, f.gamma)
            assert got.a == pytest.approx(ref.a, rel=1e-12)
            assert got.b == pytest.approx(ref.b, rel=1e-12)

    def test_pipeline_beats_ring_startup_and_tree_bandwidth_at_512(self):
        ring = get_fabric("paper_10gbe").cost("all_reduce", {"data": 512})
        tree = get_fabric("tree_10gbe").cost("all_reduce", {"data": 512})
        pipe = get_fabric("pipeline_10gbe").cost("all_reduce", {"data": 512})
        assert pipe.a < ring.a
        assert pipe.b < tree.b
        M = 100 * 1024 * 1024
        assert pipe(M) < ring(M) and pipe(M) < tree(M)

    def test_unknown_tier_algo_rejected(self):
        from repro_torch.fabric import HierarchicalFabric

        with pytest.raises(ValueError, match="algorithm"):
            HierarchicalFabric(ici_algo="carrier_pigeon")

    def test_trivial_tier_is_free(self):
        from repro_torch.fabric.hierarchical import pipeline_tree

        m = pipeline_tree(1, 45e-6, 1e-9, 1e-10)
        assert (m.a, m.b) == (0.0, 0.0)


@pytest.fixture(scope="module")
def calibrations():
    """Both packages' calibration reports, computed once."""
    return {"torch": (calibrate_train(), calibrate_serve()),
            "jax": (jsim.calibrate_train(), jsim.calibrate_serve())}


class TestCalibration:
    def test_train_replay_reproduces_committed_planning_rows(self, calibrations):
        rep = calibrations["torch"][0]
        assert rep.ok and len(rep.rows) >= 30
        assert rep.max_ratio == pytest.approx(1.0, abs=1e-9)

    def test_serve_replay_within_budget(self, calibrations):
        rep = calibrations["torch"][1]
        assert rep.ok
        assert 1.0 <= rep.max_ratio <= rep.budget
        assert {r.name.split("/")[-1] for r in rep.rows} == {"decode_step_s",
                                                             "decode_tok_per_s"}

    def test_report_json_shape(self, calibrations):
        d = calibrations["torch"][1].to_json_dict()
        assert d["kind"] == "serve" and d["ok"] is True
        assert all(r["ratio"] >= 1.0 for r in d["rows"])

    @pytest.mark.parametrize("kind", [0, 1], ids=["train", "serve"])
    def test_reports_equal_the_jax_package(self, calibrations, kind):
        got, want = calibrations["torch"][kind], calibrations["jax"][kind]
        assert got.to_json_dict() == want.to_json_dict()
        assert json.dumps(got.to_json_dict(), sort_keys=True) == \
            json.dumps(want.to_json_dict(), sort_keys=True)


class TestPaperOrdering:
    @pytest.mark.parametrize("arch,batch", [("googlenet", 64), ("resnet50", 32)])
    def test_mgwfbp_beats_wfbp_beats_synceasgd_at_8_nodes(self, arch, batch):
        """Figs. 6-7 regime: paper batches, 8-node 10GbE."""
        costs = cnn_layer_costs(arch, batch)
        spec = ClusterSpec(n_hosts=8, fabric="paper_10gbe")
        effs = {p: replay_train(spec, list(costs), p, hw=K80_CALIBRATED).mean_efficiency
                for p in POLICIES}
        assert effs["mg_wfbp"] > effs["wfbp"] > effs["synceasgd"], (arch, effs)


class TestSimReport:
    def _report(self):
        costs = cnn_layer_costs("googlenet", 64)
        rows = []
        for n in (4, 8):
            spec = ClusterSpec(n_hosts=n, fabric="paper_10gbe")
            for p in ("wfbp", "mg_wfbp"):
                res = replay_train(spec, list(costs), p, hw=K80_CALIBRATED)
                rows.append(row_from_replay(res, "googlenet", "paper_10gbe", n))
        return SimReport(rows=tuple(rows), provenance={"source": "test"})

    def test_byte_identical_across_builds(self):
        assert self._report().to_json() == self._report().to_json()

    def test_round_trip_and_select(self):
        rep = self._report()
        assert SimReport.from_json(rep.to_json()) == rep
        assert len(rep.select(n_hosts=8)) == 2
        assert rep.select(policy="wfbp", n_hosts=4)[0].policy == "wfbp"
        assert rep.best_policy(n_hosts=8) == "mg_wfbp"
        with pytest.raises(ValueError, match="no rows"):
            rep.best_policy(n_hosts=512)

    def test_save_load_and_bad_format(self, tmp_path):
        rep = self._report()
        p = rep.save(tmp_path / "report.json")
        assert SimReport.load(p) == rep
        d = json.loads(rep.to_json())
        d["format"] = 99
        with pytest.raises(ValueError, match="format"):
            SimReport.from_json_dict(d)

    def test_efficiency_table_lines(self):
        lines = self._report().efficiency_table()
        assert len(lines) == 4
        assert all("eff=" in ln and "t_iter_ms=" in ln for ln in lines)


# ---------------------------------------------------------------------------
# Cross-package parity
# ---------------------------------------------------------------------------


def test_event_queue_order_and_errors_equal_jax():
    pushes = [(2.0, "c"), (1.0, "a"), (1.0, "b"), (0.0, "z"), (2.0, "d"), (1.0 + 1e-16, "e")]
    orders = []
    for Q in (EventQueue, jsim.EventQueue):
        q = Q()
        for t, k in pushes:
            q.push(t, k, tag=k)
        popped = [q.pop() for _ in range(len(pushes))]
        orders.append(([(ev.time, ev.kind, ev.seq, ev.payload) for ev in popped],
                       q.pushed, q.popped, q.now))
    assert orders[0] == orders[1]
    for Q in (EventQueue, jsim.EventQueue):
        with pytest.raises(ValueError, match="negative"):
            Q().push(-1.0, "x")
        q = Q()
        q.push(1.0, "a")
        q.pop()
        q.push(0.5, "past")
        with pytest.raises(RuntimeError, match="before now"):
            q.pop()


GEOMETRIES = [(8, 0), (64, 0), (512, 0), (32, 16), (64, 16), (512, 16), (100, 8)]


@pytest.mark.parametrize("fabric", available_fabrics())
def test_cluster_spec_json_and_ar_model_equal_jax(fabric):
    for n, ici in GEOMETRIES:
        spec = ClusterSpec(n_hosts=n, ici_size=ici, fabric=fabric, straggler_spread=0.25,
                           seed=n, events=(ClusterEvent(at_iter=1, kind="shrink", count=3),
                                           ClusterEvent(at_iter=2, kind="kill", count=1)))
        jspec = jsim.ClusterSpec(n_hosts=n, ici_size=ici, fabric=fabric,
                                 straggler_spread=0.25, seed=n,
                                 events=(jsim.ClusterEvent(at_iter=1, kind="shrink", count=3),
                                         jsim.ClusterEvent(at_iter=2, kind="kill", count=1)))
        assert spec.to_json() == jspec.to_json()
        assert spec.name == jspec.name
        for alive in (None, n // 2 or 1, 1):
            assert spec.axis_sizes(alive) == jspec.axis_sizes(alive)
            got, want = spec.ar_model(alive), jspec.ar_model(alive)
            assert (got.a, got.b) == (want.a, want.b)


def test_straggler_draw_equals_jax_across_shrink_and_grow():
    spec = ClusterSpec(n_hosts=64, straggler_spread=0.5, seed=3)
    jspec = jsim.ClusterSpec(n_hosts=64, straggler_spread=0.5, seed=3)
    for n in (64, 32, 7, 64, 100):
        assert spec.straggler_multipliers(n) == jspec.straggler_multipliers(n)


@pytest.mark.parametrize("arch,batch", [("googlenet", 64), ("googlenet", 256),
                                        ("resnet50", 32), ("resnet50", 128)])
def test_cnn_layer_costs_equal_jax(arch, batch):
    got, want = cnn_layer_costs(arch, batch), jcnn.cnn_layer_costs(arch, batch)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert cnn_profiles.total_params(arch) == jcnn.total_params(arch)


def test_cnn_profiles_match_the_paper_totals():
    assert 12.5e6 < cnn_profiles.total_params("googlenet") < 13.5e6
    assert 25.0e6 < cnn_profiles.total_params("resnet50") < 26.0e6


def _iteration_fields(it):
    return (it.t_iter, it.t_f, it.t_b, it.t_compute, it.t_comm_total, it.t_comm_exposed,
            tuple(dataclasses.astuple(g) for g in it.groups), it.n_events,
            it.scaling_efficiency, it.speedup(8))


@pytest.mark.parametrize("policy", [*POLICIES, "dp_optimal"])
@pytest.mark.parametrize("spread", [0.0, 0.4])
def test_simulate_train_iteration_equals_jax(policy, spread):
    costs, ar = _paper_cell("resnet50", 32, 16)
    jcosts, jar = _jax_paper_cell("resnet50", 32, 16)
    mults = ClusterSpec(n_hosts=16, straggler_spread=spread, seed=1).straggler_multipliers()
    sched = build_schedule(policy, list(costs), ar, hw=K80_CALIBRATED)
    jsched = jax_build_schedule(policy, list(jcosts), jar, hw=JAX_K80)
    assert sched.groups == jsched.groups
    got = simulate_train_iteration(sched.groups, list(costs), ar, hw=K80_CALIBRATED,
                                   multipliers=mults)
    want = jsim.simulate_train_iteration(jsched.groups, list(jcosts), jar, hw=JAX_K80,
                                         multipliers=mults)
    assert _iteration_fields(got) == _iteration_fields(want)
    if spread == 0.0:
        ref = evaluate(list(sched.groups), list(costs), ar, hw=K80_CALIBRATED)
        jref = jtimeline.evaluate(list(jsched.groups), list(jcosts), jar, hw=JAX_K80)
        assert got.t_iter == ref.t_iter == jref.t_iter
        assert got.groups == tuple(ref.groups)


ELASTIC = [(2, "shrink", 32), (4, "grow", 32), (6, "kill", 8)]


@pytest.mark.parametrize("policy", POLICIES)
def test_elastic_replay_train_equals_jax(policy):
    """``benchmarks/run.py`` ``sim()``'s elastic script: 64 -> 32 -> 64, then
    8 killed."""
    spec = ClusterSpec(n_hosts=64, fabric="paper_10gbe",
                       events=tuple(ClusterEvent(a, k, c) for a, k, c in ELASTIC))
    jspec = jsim.ClusterSpec(n_hosts=64, fabric="paper_10gbe",
                             events=tuple(jsim.ClusterEvent(a, k, c) for a, k, c in ELASTIC))
    got = replay_train(spec, list(cnn_layer_costs("googlenet", 64)), policy,
                       hw=K80_CALIBRATED, n_iters=8)
    want = jsim.replay_train(jspec, list(jcnn.cnn_layer_costs("googlenet", 64)), policy,
                             hw=JAX_K80, n_iters=8)
    assert got.iterations == want.iterations
    assert (got.n_replans, got.n_kills, got.cluster) == (want.n_replans, want.n_kills,
                                                         want.cluster)
    assert (got.n_replans, got.n_kills) == (3, 8)
    if policy == "mg_wfbp":  # the committed record's elastic cell
        rec = json.loads(BENCH_SIM.read_text())["elastic"]
        assert list(got.iterations) == rec["iterations"]


@pytest.mark.parametrize("case", ["kill_failover", "slo_shed", "stragglers"])
def test_replay_serve_equals_jax(case):
    if case == "kill_failover":
        kw = dict(n=12, deadline=None)
        run = dict(n_replicas=2, slots=4, kill_at_s={0: 0.05})
    elif case == "slo_shed":
        kw = dict(n=6, deadline=1e-9)
        run = dict(n_replicas=2, slots=4)
    else:
        kw = dict(n=10, deadline=None)
        run = dict(n_replicas=3, slots=2, multipliers=(1.0, 1.3, 2.0), kill_at_s={1: 0.07})
    got = replay_serve(_load(LoadSpec, **kw), 0.01, **run)
    want = jsim.replay_serve(_load(JaxLoadSpec, **kw), 0.01, **run)
    assert got.to_json_dict() == want.to_json_dict()
    assert got.latencies_s == want.latencies_s
    if case != "stragglers":  # the committed record's serve cells
        rec = json.loads(BENCH_SIM.read_text())["serve_sim"][case]
        assert got.to_json_dict() == rec


def _whatif_report(sim, cnn, k80, cal):
    """``benchmarks/run.py`` ``sim()``'s what-if sweep: 4 fabrics x 8 / 64 /
    512 hosts x 3 policies, googlenet at batch 64."""
    costs = cnn.cnn_layer_costs("googlenet", 64)
    rows = []
    for fabric in WHATIF_FABRICS:
        ici = 16 if fabric == "tpu_v5e_tree_dcn" else 0
        for n in (8, 64, 512):
            cluster = sim.ClusterSpec(n_hosts=n, ici_size=ici, fabric=fabric)
            for p in POLICIES:
                res = sim.replay_train(cluster, list(costs), p, hw=k80)
                rows.append(sim.row_from_replay(res, "googlenet", fabric, n))
    return sim.SimReport(rows=tuple(rows), calibration=cal,
                         provenance={"arch": "googlenet", "batch": "64",
                                     "source": "benchmarks.run/sim"})


def test_whatif_sim_report_is_byte_identical_to_jax(calibrations):
    cal = {r.kind: r.to_json_dict() for r in calibrations["torch"]}
    jcal = {r.kind: r.to_json_dict() for r in calibrations["jax"]}
    got = _whatif_report(tsim, cnn_profiles, K80_CALIBRATED, cal)
    want = _whatif_report(jsim, jcnn, JAX_K80, jcal)
    assert got.to_json() == want.to_json()
    assert got.to_json() == _whatif_report(tsim, cnn_profiles, K80_CALIBRATED, cal).to_json()
    rec = json.loads(BENCH_SIM.read_text())
    assert [r.to_json_dict() for r in got.rows] == rec["whatif"]
    for fabric in WHATIF_FABRICS:
        for n in (8, 64, 512):
            assert got.best_policy(fabric=fabric, n_hosts=n) == \
                want.best_policy(fabric=fabric, n_hosts=n)
    assert SimReport.from_json(got.to_json()).to_json() == got.to_json()
