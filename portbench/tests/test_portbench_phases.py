"""The phase window (``portbench/phases.py``) and its six readers, on a
synthetic window and in a CPU rehearsal of the traced program, and the
optimizer's byte count (``portbench/optcounts.py``).

    PYTHONPATH=src python -m pytest -q portbench/tests
"""

import pathlib
import sys

import pytest
import torch

PB = pathlib.Path(__file__).resolve().parents[1]
ROOT = PB.parent
sys.path.insert(0, str(ROOT))

from portbench import bench, devtrace, optcounts, phases  # noqa: E402
from portbench.counts import HBM_BYTES_PER_S  # noqa: E402
from test_portbench_rehearsal import SEED, TRAIN_CELLS, reduced  # noqa: E402

NEW = ("optimizer_ms.train", "optimizer_roofline.train", "optimizer_launches.train",
       "forward_ms.train", "backward_ms.train", "exposed_sync_ms.train")


def synthetic() -> phases.PhaseWindow:
    """One step, µs.  The main thread opens ``step``, ``forward``,
    ``bwd_backward``, then ``sync.wait`` / ``sync.unpack`` and
    ``optimizer.update``; a second thread (autograd's, under ``dag``)
    opens ``sync.pack`` and the group's issue inside ``bwd_backward``."""
    spans = [("step", 0.0, 100.0, 0), ("forward", 1.0, 20.0, 0), ("bwd_backward", 21.0, 60.0, 0),
             ("sync.pack", 30.0, 35.0, 0), ("wfbp_group0_l1_2", 35.0, 36.0, 0),
             ("sync.wait", 61.0, 62.0, 0), ("sync.unpack", 62.0, 65.0, 0),
             ("optimizer.update", 66.0, 95.0, 0)]
    kernels = [("nvjet_tst_gemm", 10.0, 30.0), ("flash_fwd_sm90_kernel", 30.0, 40.0),
               ("flash_dkv_sm90_kernel", 40.0, 55.0), ("pack_kernel", 55.0, 57.0),
               ("nvjet_tst_gemm", 57.0, 70.0), ("unpack_kernel", 70.0, 72.0),
               ("vectorized_elementwise_kernel", 80.0, 90.0), ("direct_copy_kernel", 90.0, 95.0),
               ("Memset (Device)", 95.0, 96.0), ("fill_kernel", 100.0, 101.0)]
    launches = [2.0, 5.0, 22.0, 31.0, 40.0, 63.0, 67.0, 70.0, None, 99.0]
    return phases.PhaseWindow(kernels=kernels, host_ops=[], wall_s=110e-6, steps=1,
                              spans=spans, launch_us=launches)


def test_each_kernel_goes_to_the_innermost_span_open_at_its_launch():
    w = synthetic()
    names = [None if o is None else w.spans[o][0] for o in w.owners()]
    assert names == ["forward", "forward", "bwd_backward", "sync.pack", "bwd_backward",
                     "sync.unpack", "optimizer.update", "optimizer.update", None, "step"]
    assert w.ties[3] == ("sync.pack", 0) and w.ties[2] == ("backward", 0)
    assert w.phase_seconds("forward") == (pytest.approx(30e-6), 2)
    assert w.phase_seconds(*phases.SYNC) == (pytest.approx(4e-6), 2)
    assert w.tied_share() == pytest.approx(78 / 79)
    # the untouched yardstick: the base window's arithmetic is the same
    base = devtrace.Window(kernels=w.kernels, host_ops=[], wall_s=w.wall_s, steps=1)
    assert w.busy_s == base.busy_s and w.device_ops() == base.device_ops()


def test_idle_by_span_keys_each_gap_by_the_closing_kernels_span_and_class():
    w = synthetic()
    assert w.idle_by_span() == [["optimizer.update > elementwise", pytest.approx(8e-6)],
                                ["step > copy/cast", pytest.approx(4e-6)]]
    assert sum(s for _, s in w.idle_by_span()) == pytest.approx(
        sum(s for _, s in devtrace.Window(w.kernels, [], w.wall_s, 1).idle_gaps()))


def test_the_six_readers_arithmetic():
    w = synthetic()
    cfg = bench.cell("sc2_3b.train_4k", ROOT).config
    ctx = {"config": cfg}
    got = {m: bench.metric_reader(m)(w, ctx) for m in NEW}
    assert got["forward_ms.train"] == pytest.approx(0.030)
    assert got["backward_ms.train"] == pytest.approx(0.028)
    assert got["optimizer_ms.train"] == pytest.approx(0.015)
    assert got["optimizer_launches.train"] == 2
    assert got["exposed_sync_ms.train"] == pytest.approx(0.010)  # 70 -> 80 us
    want = 100.0 * optcounts.adamw_bytes(6_361_411_584, 3_029_710_848) / HBM_BYTES_PER_S / 15e-6
    assert got["optimizer_roofline.train"] == pytest.approx(want)
    # a window with no spans and no device kernels: nothing to read
    empty = devtrace.Window(kernels=[], host_ops=[], wall_s=1.0, steps=1)
    assert all(bench.metric_reader(m)(empty, ctx) is None for m in NEW)


def test_every_new_reader_is_listed_for_the_training_cell():
    b = bench.benchmark(ROOT)
    listed = {m["name"]: m for m in b["per_layer"]}
    for m in NEW:
        assert listed[m]["workloads"] == ["sc2_3b.train_4k"] and listed[m]["moves"] == "train_tok_s"
        assert listed[m]["source"] == "device_trace"


def test_adamw_bytes_of_starcoder2():
    # 3,029,710,848 parameters in 6,361,411,584 bytes (test_portbench_counts): 3 x those bytes
    # (read, written, the gradient read) and 16 bytes an element of f32 m and v: 67.56 GB,
    # 20.167 ms at 3.35 TB/s
    cfg = bench.cell("sc2_3b.train_4k", ROOT).config
    assert optcounts.param_totals(cfg) == (6_361_411_584, 3_029_710_848)
    n = optcounts.adamw_bytes(6_361_411_584, 3_029_710_848)
    assert n == 3 * 6_361_411_584 + 16 * 3_029_710_848 == 67_559_608_320
    assert n / HBM_BYTES_PER_S * 1e3 == pytest.approx(20.167, abs=1e-3)


def test_a_program_without_the_profiler_clock_gives_no_window(monkeypatch):
    """The readers laid over a program whose recorder has no profiler clock
    return nothing, and build nothing."""
    import repro_torch.core.profiler as profiler

    class Older:
        def __init__(self, clock_ns=None, *, cuda: bool = False):
            pass

    monkeypatch.setattr(profiler, "TraceRecorder", Older)
    monkeypatch.setattr(phases, "run", lambda *a, **k: pytest.fail("built a program"))
    assert not phases.recorder_supported()
    traced = devtrace.Window(kernels=[("pack_kernel", 0.0, 1.0)], host_ops=[], wall_s=1.0,
                             steps=1)
    ctx = {"config": bench.cell("sc2_3b.train_4k", ROOT).config}
    assert all(bench.metric_reader(m)(traced, ctx) is None for m in NEW)


def test_a_traced_device_window_gets_one_phase_run_for_all_readers(monkeypatch):
    """Beside a window that traced the device, the readers share one run of
    the cell's program with the recorder on, kept in the run's ``ctx``."""
    calls = []

    def run(cell, device, seed=phases.SEED, arch=None):
        calls.append((cell.name, device))
        return synthetic()

    monkeypatch.setattr(phases, "run", run)
    cell = bench.cell("sc2_3b.train_4k", ROOT)
    traced = devtrace.Window(kernels=[("pack_kernel", 0.0, 1.0)], host_ops=[], wall_s=1.0,
                             steps=1)
    ctx = {"config": cell.config, "mix": cell.traffic}
    got = {m: bench.metric_reader(m)(traced, ctx) for m in NEW}
    assert calls == [("sc2_3b.train_4k", torch.device("cuda", 0))]
    assert got["optimizer_launches.train"] == 2 and got["forward_ms.train"] == pytest.approx(0.03)
    assert phases.cell_of(dict(ctx, mix=dict(cell.traffic, seq=2048))) is None


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_the_phase_window_rehearsal(name):
    """The cell's program at its reduced size on the CPU, traced with the
    recorder: the window carries each step's spans, nested in its ``step``."""
    cell, arch = reduced(name)
    w = phases.run(cell, torch.device("cpu"), SEED, arch=arch)
    n = cell.workload["trace_steps"]
    assert w.steps == n and w.kernels == []  # the CPU runs no device kernels
    for step in range(n):
        mine = [s for s in w.spans if s[3] == step]
        got = {phases.phase(s[0]) for s in mine}
        assert got == {"step", "forward", "backward", "sync.pack", "issue", "sync.wait",
                       "sync.unpack", "optimizer.update"}
        (whole,) = [s for s in mine if s[0] == "step"]
        assert all(whole[1] <= s[1] <= s[2] <= whole[2] for s in mine)
    assert phases.recorder_supported()
