"""Profiler parity: the port's ``core.profiler`` timers and trace recorder
against the JAX package's.

The timers run under one scripted fake clock on both sides and must
return the same number; ``TraceRecorder`` under one fake ``clock_ns`` must
give identical Chrome-trace dicts, and each package must read the other's
files; ``parse_trace_spans`` + ``overlap_report`` on the committed fixture
must give dicts identical to the JAX package's (whose golden numbers
``tests/test_trace_golden.py`` pins).  Then the port's recorder on real
steps of the reduced model on the CPU.
"""

import gzip
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_env import world1
from repro.core.profiler import (
    TraceRecorder as JaxRecorder,
    overlap_report as jax_overlap_report,
    parse_trace_spans as jax_parse,
    time_segment as jax_time_segment,
)
from repro.planning.costs import min_of_k as jax_min_of_k, time_collective_call as jax_tcc
from repro.runtime import StepTimer as JaxStepTimer
from repro_torch.core.profiler import (
    BWD_SPAN_PREFIX,
    GROUP_SPAN_RE,
    TraceRecorder,
    overlap_report,
    parse_trace_spans,
    time_segment,
)
from repro_torch.planning import min_of_k, time_collective_call
from repro_torch.runtime import StepTimer

FIXTURE = pathlib.Path(__file__).parent / "data" / "overlap_trace.json"


def _script(seed, n=64):
    """A fake monotone clock: seeded increments with a few 50x outliers."""
    rng = np.random.default_rng(seed)
    steps = rng.uniform(1e-4, 2e-3, n)
    steps[rng.integers(0, n, 6)] *= 50.0
    return list(np.cumsum(steps))


def _clock(ticks):
    it = iter(ticks)
    return lambda: float(next(it))


@pytest.mark.parametrize("warmup,repeats", [(0, 1), (1, 3), (2, 5)])
def test_time_segment_matches_reference(warmup, repeats):
    ticks = _script(warmup * 10 + repeats)
    calls = {"jax": 0, "torch": 0}

    def jfn(x):
        calls["jax"] += 1
        return jnp.asarray(x)

    def tfn(x):
        calls["torch"] += 1
        return x

    j = jax_time_segment(jfn, 1.0, warmup=warmup, repeats=repeats, clock=_clock(ticks))
    t = time_segment(tfn, torch.ones(()), warmup=warmup, repeats=repeats, clock=_clock(ticks))
    assert t == j
    assert calls["torch"] == calls["jax"] == warmup + repeats


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_time_collective_call_matches_reference(seed):
    ticks = _script(100 + seed, n=128)
    j = jax_tcc(lambda v: v + 0, jnp.ones(4), repeats=4, warmup=2, clock=_clock(ticks))
    t = time_collective_call(lambda v: v + 0, torch.ones(4), repeats=4, warmup=2,
                             clock=_clock(ticks))
    assert t == j


@pytest.mark.parametrize("repeats,max_retries", [(1, None), (3, None), (5, 0), (4, 2)])
def test_min_of_k_matches_reference(repeats, max_retries):
    """Scripted samples with outliers: the same retries, the same min."""
    samples = [5.0, 0.9, 40.0, 1.1, 0.95, 30.0, 20.0, 1.0, 12.0, 0.99, 50.0, 0.5]
    j = jax_min_of_k(iter(samples).__next__, repeats, max_retries=max_retries)
    t = min_of_k(iter(samples).__next__, repeats, max_retries=max_retries)
    assert t == j


def test_step_timer_matches_reference():
    ticks = _script(9, n=200)
    jt = JaxStepTimer(window=5, skip_first=2, clock=_clock(ticks))
    tt = StepTimer(window=5, skip_first=2, clock=_clock(ticks))
    for k in range(30):
        if k == 12:
            jt.skip(3)
            tt.skip(3)
        if k == 20:
            jt.reset(1)
            tt.reset(1)
        jt.start()
        tt.start()
        assert tt.stop() == jt.stop()
        assert len(tt) == len(jt)
        assert tt.median() == jt.median()
        jt.observe(0.01 * k)
        tt.observe(0.01 * k)
    with pytest.raises(ValueError):
        StepTimer().stop()
    assert StepTimer().median() is None


def _marks():
    """Backward, two groups inside it, one after; two devices; a B/E pair
    cleared mid-step leaves an unmatched end."""
    rng = np.random.default_rng(3)
    out = []
    for dev in (0, 1):
        out += [("bwd_head", "B", 0, dev), ("wfbp_group0_l6_6", "B", 4096, dev),
                ("bwd_head", "E", 0, dev), ("bwd_stage0", "B", 0, dev),
                ("wfbp_group0_l6_6", "E", 4096, dev), ("wfbp_group1_l2_5", "B", 65536, dev),
                ("bwd_stage0", "E", 0, dev), ("wfbp_group1_l2_5", "E", 65536, dev),
                ("wfbp_group2_l1_1", "B", 512, dev), ("wfbp_group2_l1_1", "E", 512, dev),
                ("bwd_embed", "E", 0, dev)]
    ticks = list(np.cumsum(rng.integers(1_000, 90_000, len(out))))
    return out, ticks


def test_trace_recorder_matches_reference(tmp_path):
    marks, ticks = _marks()
    jr = JaxRecorder(clock_ns=iter(ticks).__next__)
    tr = TraceRecorder(clock_ns=iter(ticks).__next__)
    for name, ph, nbytes, dev in marks:
        jr._mark(name, ph, nbytes, dev)
        tr._mark(name, ph, nbytes, dev)
    assert len(tr) == len(jr) == len(marks)
    assert tr.to_chrome_trace() == jr.to_chrome_trace()
    assert tr.spans() == [type(s)(**vars(s)) for s in tr.spans()]
    # each package reads the other's files, plain and gzip
    for name in ("t.json", "t.json.gz"):
        tr.save(tmp_path / ("port_" + name))
        jr.save(tmp_path / ("jax_" + name))
        from_port = jax_parse(tmp_path / ("port_" + name))
        from_jax = parse_trace_spans(tmp_path / ("jax_" + name))
        assert [vars(s) for s in from_port] == [vars(s) for s in jr.spans()]
        assert [vars(s) for s in from_jax] == [vars(s) for s in tr.spans()]
    assert overlap_report(tr.spans()) == jax_overlap_report(jr.spans())
    tr.clear()
    assert len(tr) == 0 and tr.spans() == []


def test_parse_and_overlap_report_match_reference_on_the_fixture():
    raw = FIXTURE.read_text()
    tspans = parse_trace_spans(FIXTURE)
    jspans = jax_parse(FIXTURE)
    assert [vars(s) for s in tspans] == [vars(s) for s in jspans]
    assert parse_trace_spans(json.loads(raw)) == tspans
    assert parse_trace_spans(raw) == tspans
    trep, jrep = overlap_report(tspans), jax_overlap_report(jspans)
    assert trep == jrep
    # the golden numbers of tests/test_trace_golden.py
    assert trep["n_comm_spans"] == 48 and trep["n_bwd_spans"] == 48
    assert trep["n_overlapped_starts"] == 40
    assert trep["total_comm_us"] == pytest.approx(42091.329, abs=1e-6)
    assert trep["overlap_fraction"] == pytest.approx(0.4398994622, abs=1e-9)
    assert overlap_report([]) == jax_overlap_report([])


def test_parse_folds_begin_end_pairs_like_reference(tmp_path):
    events = {"traceEvents": [
        {"name": "wfbp_group0_l1_1", "ph": "B", "pid": 0, "ts": 10.0, "args": {"bytes": 8}},
        {"name": "bwd_backward", "ph": "X", "pid": 0, "ts": 0.0, "dur": 30.0},
        {"name": "wfbp_group0_l1_1", "ph": "E", "pid": 0, "ts": 40.0},
        {"name": "wfbp_group1_l0_0", "ph": "E", "pid": 0, "ts": 41.0},
        {"ph": "X", "pid": 0, "ts": 1.0, "dur": 1.0},
    ]}
    p = tmp_path / "be.json.gz"
    p.write_bytes(gzip.compress(json.dumps(events).encode()))
    assert [vars(s) for s in parse_trace_spans(p)] == [vars(s) for s in jax_parse(p)]
    assert overlap_report(parse_trace_spans(events)) == jax_overlap_report(jax_parse(events))


@pytest.mark.parametrize("issue", ["post", "dag"])
def test_recorder_on_real_steps(issue, tmp_path):
    """The reduced model's steps under the recorder on the CPU: one comm
    span per group, carrying the group's wire bytes; backward spans (one
    under post, one per unit under dag); the trace reads back in both
    packages.  The first step's spans are cleared, as ``--dryrun`` does."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.sync import SyncConfig
    from repro_torch.core.trainer import MGWFBPEngine
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.core.trainer import batch_to_device
    from repro_torch.core.comm_model import AllReduceModel
    from repro_torch.models import Transformer, param_shapes
    from repro_torch.optim import make_optimizer

    world1()
    cfg = get_reduced("tinyllama-1.1b", param_dtype=torch.float32)
    eng = MGWFBPEngine.build(cfg, param_shapes(cfg), ar_model=AllReduceModel(a=5e-5, b=1e-9),
                             tokens_per_device=128, policy="wfbp",
                             sync_config=SyncConfig(fuse="arena"))
    model = Transformer(cfg, device="cpu", seed=0)
    rec = TraceRecorder()
    step = eng.make_train_step(model, make_optimizer("sgd"), issue=issue, recorder=rec)
    data = make_stream(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2))
    try:
        for k in range(2):
            if k:
                assert len(rec) > 0
                rec.clear()
            step(batch_to_device(data.batch_at(k), torch.device("cpu")))
    finally:
        step.close()
    spans = rec.spans()
    comm = [s for s in spans if GROUP_SPAN_RE.match(s.name)]
    bwd = [s for s in spans if s.name.startswith(BWD_SPAN_PREFIX)]
    n_groups = eng.sync.n_groups
    assert len(comm) == n_groups
    for s in comm:
        gi = int(GROUP_SPAN_RE.match(s.name).group(1))
        assert s.args["bytes"] == eng.sync.group_wire_bytes[gi]
        assert s.name == eng.sync.span_names[gi]
    units = 2 + cfg.n_stages  # head, stages, embed
    assert len(bwd) == (1 if issue == "post" else units)
    rep = overlap_report(spans)
    assert rep["n_comm_spans"] == n_groups
    if issue == "post":
        assert rep["n_overlapped_starts"] == 0 and rep["overlap_fraction"] == 0.0
    else:
        # every group but the last (the embed's, which issues once backward
        # has ended) issues inside backward
        assert rep["n_overlapped_starts"] == n_groups - 1
        assert not rep["groups"][-1]["starts_before_bwd_end"]
    path = tmp_path / "trace.json.gz"
    rec.save(path)
    assert jax_overlap_report(jax_parse(path)) == overlap_report(parse_trace_spans(path))
