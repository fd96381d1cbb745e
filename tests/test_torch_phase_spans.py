"""The training step's phase spans on the profiler's clock
(``TraceRecorder(profiler_clock=True)``), on reduced StarCoder2 on the
CPU at world 1 (gloo), under ``post`` and ``dag``: each step's ``step``
span holds ``forward``, backward, every group's ``sync.pack`` / issue /
``sync.wait`` / ``sync.unpack`` and ``optimizer.update``; the spans'
args are the sync's and the optimizer's counts; under ``torch.profiler``
every ``aten::`` operator lies inside the spans it overlaps (one clock);
and the recorder leaves the parameters bit for bit as they are without
it.  The recorder's other modes record none of the phase spans.
"""

import re

import pytest
import torch

from _torch_env import bits, world1
from repro_torch.core.profiler import BWD_SPAN_PREFIX, GROUP_SPAN_RE, TraceRecorder

PHASES = ("step", "forward", "sync.pack", "sync.wait", "sync.unpack", "optimizer.update")


def _step(issue: str, recorder=None, seed: int = 0):
    from repro_torch.configs import get_reduced
    from repro_torch.core.comm_model import AllReduceModel
    from repro_torch.core.sync import SyncConfig
    from repro_torch.core.trainer import MGWFBPEngine
    from repro_torch.models import Transformer, param_shapes
    from repro_torch.optim import make_optimizer

    world1()
    cfg = get_reduced("starcoder2-3b", param_dtype=torch.float32)
    eng = MGWFBPEngine.build(cfg, param_shapes(cfg), ar_model=AllReduceModel(a=5e-5, b=1e-9),
                             tokens_per_device=64, policy="mg_wfbp",
                             sync_config=SyncConfig(fuse="arena"))
    model = Transformer(cfg, device="cpu", seed=seed)
    step = eng.make_train_step(model, make_optimizer("adamw"), issue=issue, recorder=recorder)
    return cfg, eng, model, step


def _batch(cfg, k: int) -> dict:
    g = torch.Generator().manual_seed(100 + k)
    tokens = torch.randint(0, cfg.vocab, (2, 33), generator=g)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


def _run(issue: str, recorder=None, steps: int = 2):
    cfg, eng, model, step = _step(issue, recorder)
    try:
        for k in range(steps):
            step(_batch(cfg, k))
    finally:
        step.close()
    return cfg, eng, model, step


def _inside(inner, outer) -> bool:
    return outer.start_us <= inner.start_us and inner.end_us <= outer.end_us


@pytest.mark.parametrize("issue", ["post", "dag"])
def test_each_step_holds_its_phases_nested_by_time(issue):
    rec = TraceRecorder(profiler_clock=True)
    cfg, eng, _, step = _run(issue, rec)
    spans = rec.spans()
    n_groups = eng.sync.n_groups
    steps = [s for s in spans if s.name == "step"]
    assert [s.args["step"] for s in steps] == [0, 1]
    for whole in steps:
        mine = [s for s in spans if s.args.get("step") == whole.args["step"] and s is not whole]
        assert all(_inside(s, whole) for s in mine)
        by = {n: [s for s in mine if s.name == n] for n in PHASES[1:]}
        comm = [s for s in mine if GROUP_SPAN_RE.match(s.name)]
        bwd = [s for s in mine if s.name.startswith(BWD_SPAN_PREFIX)]
        assert len(by["forward"]) == len(by["optimizer.update"]) == 1
        for n in ("sync.pack", "sync.wait", "sync.unpack"):
            assert sorted(s.args["group"] for s in by[n]) == list(range(n_groups))
        assert len(comm) == n_groups
        assert len(bwd) == (1 if issue == "post" else 2 + cfg.n_stages)
        (fwd,), (opt,) = by["forward"], by["optimizer.update"]
        bwd_start, bwd_end = min(s.start_us for s in bwd), max(s.end_us for s in bwd)
        assert fwd.end_us <= bwd_start
        for gi in range(n_groups):
            pack, = [s for s in by["sync.pack"] if s.args["group"] == gi]
            wait, = [s for s in by["sync.wait"] if s.args["group"] == gi]
            unpack, = [s for s in by["sync.unpack"] if s.args["group"] == gi]
            issued, = [s for s in comm if s.name == eng.sync.span_names[gi]]
            assert pack.end_us <= issued.start_us and issued.end_us <= wait.start_us
            assert wait.end_us <= unpack.start_us <= unpack.end_us <= opt.start_us
            if issue == "post":
                assert bwd_end <= pack.start_us
        if issue == "dag":
            # every group but the embed's packs and issues inside a unit's span
            inside = [gi for gi in range(n_groups)
                      if any(_inside(p, b) for b in bwd for p in by["sync.pack"]
                             if p.args["group"] == gi)]
            assert inside == list(range(n_groups - 1))


@pytest.mark.parametrize("issue", ["post", "dag"])
def test_span_args_are_the_sync_and_optimizer_counts(issue):
    rec = TraceRecorder(profiler_clock=True)
    cfg, eng, model, step = _run(issue, rec, steps=1)
    sync = eng.sync
    params = dict(model.named_parameters())
    for s in rec.spans():
        assert s.args["step"] == 0 and isinstance(s.args["thread"], int)
        if s.name == "sync.pack":
            gi = s.args["group"]
            assert s.args["bytes"] == sync.group_wire_bytes[gi]
            assert s.args["leaves"] == len(sync.group_names[gi])
        elif GROUP_SPAN_RE.match(s.name):
            gi = int(GROUP_SPAN_RE.match(s.name).group(1))
            assert s.args["bytes"] == sync.group_wire_bytes[gi]
        elif s.name == "optimizer.update":
            assert s.args["leaves"] == len(params) == len(step.opt_state.m)
            assert s.args["elements"] == sum(p.numel() for p in params.values())
        elif s.name == "forward":
            assert s.args["tokens"] == 2 * 32


@pytest.mark.parametrize("issue", ["post", "dag"])
def test_spans_and_profiler_events_share_a_clock(issue):
    """Under ``torch.profiler`` (CPU activity) every ``aten::`` operator
    that overlaps a span lies inside it, once the spans are put on the
    profiler's µs by its ``trace_start_ns``; AdamW's square roots all lie
    in ``optimizer.update``, one a leaf, and the products in the phases
    that run them."""
    from torch.profiler import ProfilerActivity, profile

    rec = TraceRecorder(profiler_clock=True)
    cfg, eng, model, step = _step(issue, rec)
    try:
        step(_batch(cfg, 0))  # warm-up
        rec.clear()
        batch = _batch(cfg, 1)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(batch)
    finally:
        step.close()
    spans = rec.spans(origin_ns=prof.profiler.kineto_results.trace_start_ns())
    aten = [e for e in prof.events() if e.name.startswith("aten::")]
    main = {e.thread for e in aten if e.name == "aten::embedding"}
    aten = [e for e in aten if e.thread in main]  # not the gloo worker's
    assert len(aten) > 1000
    for s in spans:
        for e in aten:
            a, b = e.time_range.start, e.time_range.end
            if a < s.end_us and b > s.start_us:  # overlaps
                assert s.start_us <= a and b <= s.end_us, (s.name, e.name, a, b, s)
    (whole,) = [s for s in spans if s.name == "step"]
    assert all(whole.start_us <= e.time_range.start and e.time_range.end <= whole.end_us
               for e in aten)
    (opt,) = [s for s in spans if s.name == "optimizer.update"]
    roots = [e for e in aten if e.name == "aten::sqrt"]
    assert len(roots) == len(dict(model.named_parameters()))
    assert all(opt.start_us <= e.time_range.start and e.time_range.end <= opt.end_us
               for e in roots)
    (fwd,) = [s for s in spans if s.name == "forward"]
    bwd = [s for s in spans if s.name.startswith(BWD_SPAN_PREFIX)]
    products = [e for e in aten if re.fullmatch(r"aten::(mm|addmm)", e.name)]
    in_fwd = [e for e in products if fwd.start_us <= e.time_range.start <= fwd.end_us]
    in_bwd = [e for e in products
              if any(b.start_us <= e.time_range.start <= b.end_us for b in bwd)]
    assert in_fwd and in_bwd and len(in_fwd) + len(in_bwd) == len(products)


@pytest.mark.parametrize("issue", ["post", "dag"])
def test_the_recorder_leaves_the_parameters_bitwise(issue):
    _, _, plain, _ = _run(issue)
    _, _, traced, _ = _run(issue, TraceRecorder(profiler_clock=True))
    a, b = dict(plain.named_parameters()), dict(traced.named_parameters())
    assert a.keys() == b.keys()
    for n in a:
        assert (bits(a[n]) == bits(b[n])).all(), n


@pytest.mark.parametrize("issue", ["post", "dag"])
def test_the_other_modes_record_no_phase_spans(issue):
    """The host-clock mode that ``--dryrun`` and ``overlap_report`` read
    keeps the comm and backward spans alone."""
    rec = TraceRecorder()
    _run(issue, rec, steps=1)
    names = {s.name for s in rec.spans()}
    assert not names & set(PHASES)
    assert all(GROUP_SPAN_RE.match(n) or n.startswith(BWD_SPAN_PREFIX) for n in names)
    assert all(set(s.args) <= {"bytes"} for s in rec.spans())


def test_the_profiler_clock_on_a_scripted_clock():
    """Marks on an injected clock: ``origin_ns`` is taken off in integer
    ns, ``span_end(work=...)`` marks the issue's return without touching
    the work, and every span carries its step and thread."""
    import threading

    ticks = iter([1_700_000_000_000_000_000 + k * 1_500 for k in range(12)])
    rec = TraceRecorder(lambda: next(ticks), profiler_clock=True)

    class Work:
        def get_future(self):
            raise AssertionError("the profiler's clock does not wait for the work")

        wait = get_future

    rec.step_begin(device=0)
    rec.phase_begin("sync.pack", device=0, nbytes=64, group=3, leaves=2)
    rec.phase_end("sync.pack", device=0)
    rec.span_begin("wfbp_group3_l1_2", device=0, nbytes=64)
    rec.span_end("wfbp_group3_l1_2", device=0, work=Work())
    rec.phase_end("step", device=0)
    rec.step_begin(device=0)
    rec.phase_end("step", device=0)
    spans = rec.spans(origin_ns=1_700_000_000_000_000_000)
    assert [(s.name, s.start_us, s.dur_us) for s in spans] == [
        ("step", 0.0, 7.5), ("sync.pack", 1.5, 1.5), ("wfbp_group3_l1_2", 4.5, 1.5),
        ("step", 9.0, 1.5)]
    tid = threading.get_ident()
    assert spans[1].args == {"bytes": 64, "group": 3, "leaves": 2, "step": 0, "thread": tid}
    assert spans[2].args == {"bytes": 64, "step": 0, "thread": tid}
    assert spans[3].args == {"step": 1, "thread": tid}
    with pytest.raises(ValueError):
        TraceRecorder(cuda=True, profiler_clock=True)
