"""The program's training-step phases over a device trace: a window whose
kernels are each tied to the innermost span of the program that was open
when the runtime call that launched it ran.

The program records its spans with ``core.profiler.TraceRecorder(
profiler_clock=True)``: each mark is a ``time.time_ns()`` on the host,
the clock ``torch.profiler`` stamps its events with, so the spans go onto
the trace's µs by its ``trace_start_ns()``.  A kernel's launch is the host
event that carries its correlation id (``cudaLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...).  The spans are ``step``,
``forward``, ``bwd_*`` (``backward`` here), ``sync.pack``,
``wfbp_group*`` (``issue`` here: the ``issue()`` call), ``sync.wait``,
``sync.unpack`` and ``optimizer.update``.

The cell's driver traces its window without the recorder; the readers of
the phase metrics get a window of their own from :func:`window_for`: the
same program, built and driven as the driver builds and drives it,
traced again with the recorder on, once a run.  A program without the
recorder's profiler clock gives no such window, and its readers nothing.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import inspect
import pathlib
import re
import time

import torch

from . import bench, devtrace, traffic
from .drivers import train

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the phase window's weights and batches (its timing does not depend on their values;
#: the comparison with the reference is the driver's window's)
SEED = 2**31 + 35
GROUP_SPAN = re.compile(r"^wfbp_group\d+_l\d+_\d+$")
SYNC = ("sync.pack", "issue", "sync.wait", "sync.unpack")


def phase(span: str) -> str:
    """A span's phase: ``backward`` for ``bwd_*``, ``issue`` for a group's
    ``wfbp_group*``, else its own name."""
    if span.startswith("bwd_"):
        return "backward"
    if GROUP_SPAN.match(span):
        return "issue"
    return span


@dataclasses.dataclass
class PhaseWindow(devtrace.Window):
    """A traced window with the program's ``spans`` (name, start_us,
    end_us, step) and, for each kernel, the host time of the call that
    launched it (``launch_us``, None where none was traced)."""

    spans: list[tuple[str, float, float, int]] = dataclasses.field(default_factory=list)
    launch_us: list[float | None] = dataclasses.field(default_factory=list)

    def owners(self) -> list[int | None]:
        """For each kernel, the index in ``spans`` of the innermost span
        open at its launch (the latest-started one), or None."""
        events = []
        for i, (_, a, b, _) in enumerate(self.spans):
            events += [(a, 0, i), (b, 2, i)]
        events += [(t, 1, k) for k, t in enumerate(self.launch_us) if t is not None]
        events.sort()
        out: list[int | None] = [None] * len(self.kernels)
        active: list[int] = []  # open spans, in the order they began
        for _, kind, i in events:
            if kind == 0:
                active.append(i)
            elif kind == 2:
                active.remove(i)
            elif active:
                out[i] = active[-1]
        return out

    @functools.cached_property
    def ties(self) -> list[tuple[str, int] | None]:
        """For each kernel, the (phase, step) of the span that launched it."""
        return [None if o is None else (phase(self.spans[o][0]), self.spans[o][3])
                for o in self.owners()]

    def phase_seconds(self, *phases: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels launched in ``phases``."""
        t, n = 0.0, 0
        for (_, a, b), tie in zip(self.kernels, self.ties):
            if tie is not None and tie[0] in phases:
                t += (b - a) / 1e6
                n += 1
        return t, n

    def tied_share(self) -> float:
        """The share of the kernels' device time launched inside a span."""
        tot = sum(b - a for _, a, b in self.kernels)
        tied = sum(b - a for (_, a, b), tie in zip(self.kernels, self.ties) if tie is not None)
        return tied / tot if tot else 0.0

    def exposed_sync_s(self) -> float | None:
        """Device wall seconds a step from the end of backward's last
        kernel to the start of the optimizer's first, idle included."""
        ends: dict[int, float] = {}
        starts: dict[int, float] = {}
        for (_, a, b), tie in zip(self.kernels, self.ties):
            if tie is None:
                continue
            ph, step = tie
            if ph == "backward":
                ends[step] = max(ends.get(step, b), b)
            elif ph == "optimizer.update":
                starts[step] = min(starts.get(step, a), a)
        gaps = [starts[s] - ends[s] for s in ends if s in starts]
        return sum(gaps) / len(gaps) / 1e6 if gaps else None

    def idle_by_span(self) -> list[list]:
        """Idle device time between kernels (``idle_gaps``'s gaps), summed by
        the phase in which the kernel that closed each gap was launched and
        that kernel's class."""
        ties = self.ties
        order = sorted(range(len(self.kernels)),
                       key=lambda i: (self.kernels[i][1], self.kernels[i][2], self.kernels[i][0]))
        by: dict[str, float] = {}
        end = self.kernels[order[0]][2] if order else 0.0
        for i in order[1:]:
            name, a, b = self.kernels[i]
            if a - end >= devtrace.GAP_MIN_US:
                key = f"{ties[i][0] if ties[i] else 'no span'} > {devtrace.kernel_class(name)}"
                by[key] = by.get(key, 0.0) + (a - end) / 1e6
            end = max(end, b)
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:devtrace.TOP]]


def from_profile(prof, wall_s: float, steps: int, recorder=None) -> PhaseWindow:
    """``devtrace.from_profile``'s window, with each kernel's launch by
    correlation id and the ``recorder``'s spans on the trace's µs."""
    base = devtrace.from_profile(prof, wall_s, steps)
    launch: dict[int, float] = {}
    ids = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ids.append(e.id)
        elif not e.name.startswith("Activity Buffer"):
            launch.setdefault(e.id, float(e.time_range.start))
    spans = []
    if recorder is not None:
        origin = prof.profiler.kineto_results.trace_start_ns()
        spans = [(s.name, s.start_us, s.end_us, s.args["step"])
                 for s in recorder.spans(origin_ns=origin)]
    return PhaseWindow(kernels=base.kernels, host_ops=base.host_ops, wall_s=wall_s, steps=steps,
                       spans=spans, launch_us=[launch.get(i) for i in ids])


def recorder_supported() -> bool:
    """Whether the program's recorder marks on the profiler's clock."""
    from repro_torch.core.profiler import TraceRecorder

    return "profiler_clock" in inspect.signature(TraceRecorder).parameters


def adopt(prog: train.Program, recorder) -> None:
    """Train on with a new step under ``recorder`` (None: none) that takes
    over the optimizer state of the current one, as the launcher's
    ``TrainSetup.adopt`` does."""
    old = prog.step_fn
    old.close()
    prog.step_fn = prog.engine.make_train_step(
        prog.model, prog.optimizer, lr=prog.config["optimizer"]["lr"], issue=prog.issue,
        residual=old.residual, opt_state=old.opt_state, recorder=recorder)


def traced_window(prog: train.Program, batches, steps: int, start: int,
                  record: bool = True) -> PhaseWindow:
    """``train.traced_window``'s window, with the step's spans recorded on
    the profiler's clock (``record``) or without them."""
    from repro_torch.core.profiler import TraceRecorder
    from torch.profiler import ProfilerActivity, profile

    rec = TraceRecorder(profiler_clock=True) if record else None
    adopt(prog, rec)
    cuda = prog.device.type == "cuda"
    gc.collect()  # earlier windows' garbage (the profiler's event trees) is not this one's
    train.sync(prog.device)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for i in range(start, start + steps):
            prog.step(batches[i % len(batches)])
        train.sync(prog.device)
        wall = time.perf_counter() - t0
    return from_profile(prof, wall, steps, rec)


def run(cell, device: torch.device, seed: int = SEED, arch=None) -> PhaseWindow:
    """Build the cell's program, drive it through the cell's first steps
    and trace ``trace_steps`` more with the recorder on."""
    config, mix, w = cell.config, cell.traffic, cell.workload
    prog = train.Program(config, w["program"], device, seed, mix["batch"] * mix["seq"], arch)
    try:
        batches = traffic.lm_batches(mix, config["vocab"], seed, device)
        for i in range(w["check_steps"]):
            prog.step(batches[i % len(batches)])
        window = traced_window(prog, batches, w["trace_steps"], w["check_steps"])
    finally:
        prog.close()
        del prog
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return window


def cell_of(ctx: dict):
    """The cell whose configuration and traffic ``ctx`` holds."""
    for entry in bench.benchmark(ROOT)["workloads"]:
        if entry["config"] != ctx["config"].get("name"):
            continue
        cell = bench.cell(entry["name"], ROOT)
        if cell.traffic == ctx["mix"] and cell.workload["driver"] == "train":
            return cell
    return None


def window_for(window, ctx: dict) -> PhaseWindow | None:
    """The phase window for the readers of a traced run: ``window`` itself
    when it carries spans; else, where ``window`` traced the device, one
    traced run of the cell's program with the recorder on (on the first
    CUDA device, as the command runs), made once a run and kept in
    ``ctx``; else None."""
    if isinstance(window, PhaseWindow) and window.spans:
        return window
    if not window.kernels:
        return None
    if "phase_window" not in ctx:
        cell = cell_of(ctx) if recorder_supported() else None
        ctx["phase_window"] = None if cell is None else run(cell, torch.device("cuda", 0))
    return ctx["phase_window"]
