"""Measured costs and self-recorded traces (counterpart of
``repro/core/profiler.py``).

``time_segment`` is the measured counterpart of a segment's analytic cost:
it runs a callable, discards warm-up calls and keeps the min of the timed
ones.  On a CUDA device every clock read follows
``torch.cuda.synchronize``, so a timed call holds the kernels it launched,
not only their launches.

Trace-first overlap verification
--------------------------------
:class:`TraceRecorder` records named spans of the executed step: one
``wfbp_group{gi}_l{lo}_{hi}`` span per schedule group around its
all-reduce (carrying the group's wire bytes), and ``bwd_*`` spans over
backward.  On the CPU a mark is the host clock (``clock_ns``, injectable)
at the moment the value it marks exists; on a CUDA device a mark is a
timing ``torch.cuda.Event`` recorded on the stream where the work runs,
and a comm span ends on a stream of the recorder's own that waits for the
collective, so it ends when the collective does, not where the step
later waits for it.  Recordings serialize to Chrome-trace JSON (``ph:
"X"`` complete events, ``pid`` = device, µs), the format the JAX package
writes; :func:`parse_trace_spans` reads either package's files, and
:func:`overlap_report` computes the measured overlap of comm and backward.

Not ported: ``CollectiveStats``, ``parse_collectives`` and
``segment_cost`` read compiled HLO text, which PyTorch does not produce.
The port counts its collectives at the ``fabric.ops.issue`` seam instead.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import pathlib
import re
import threading
import time

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_segment(fn, *args, warmup: int = 1, repeats: int = 3, clock=None,
                 device=None) -> float:
    """Wall-clock one segment: discard ``warmup`` calls (caches, lazy
    builds), keep the min of ``repeats`` timed calls — the same latency
    estimator ``MeasuredComm.time_psums`` uses, so compute- and comm-side
    measured costs are directly comparable.  On a CUDA ``device`` the
    device is synchronized before each clock read.  ``clock`` is
    injectable (FakeClock pattern) so tests never sleep or assert on
    real wall-clock deltas."""
    if clock is None:
        clock = time.perf_counter
    for _ in range(max(0, warmup)):
        fn(*args)
    _sync(device)
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = clock()
        fn(*args)
        _sync(device)
        best = min(best, clock() - t0)
    return best


# ---------------------------------------------------------------------------
# Self-recorded execution traces (the DAG-step overlap proof)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Span:
    """One timed scope of one device, in Chrome-trace units (µs)."""

    name: str
    device: int
    start_us: float
    dur_us: float
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


#: ``wfbp_group{gi}_l{lo}_{hi}`` — the sync engine's per-group scope name.
GROUP_SPAN_RE = re.compile(r"^wfbp_group(\d+)_l(\d+)_(\d+)$")

#: Backward-compute scopes the train step records (``bwd_<unit>``).
BWD_SPAN_PREFIX = "bwd_"


class TraceRecorder:
    """Span recorder for eager training steps.

    ``span_begin`` / ``span_end`` mark a span's ends at the point of the
    program where they are called; the pair is matched by name per
    device (FIFO).  ``device`` is the trace's ``pid`` (the rank).

    On the CPU (``cuda=False``) a mark is ``clock_ns()`` (default
    ``time.perf_counter_ns``).  ``span_end(..., work=w)`` of an
    asynchronous collective marks when ``w`` completes (its future's
    callback), which may run on the backend's thread: appends are
    lock-guarded.

    With ``cuda=True`` a mark is a timing event recorded on the current
    stream, which is where the step's kernels run; ``span_end(...,
    work=w)`` records it on a stream of the recorder's own made to wait
    for ``w``, so it marks the collective's completion without making the
    step's stream wait.  Events resolve to µs from the first mark when
    the spans are read (``spans`` synchronizes on them).
    """

    def __init__(self, clock_ns=None, *, cuda: bool = False):
        self._clock_ns = clock_ns or time.perf_counter_ns
        self.cuda = cuda
        self._lock = threading.Lock()
        # name, ph, dev, t_ns (an int, or a CUDA event), nbytes
        self._events: list[tuple] = []
        self._side_stream = None
        self._origin = None

    # -- recording (called from inside the step) ----------------------------

    def _mark(self, name: str, ph: str, nbytes: int, device, stamp=None) -> None:
        t = int(self._clock_ns()) if stamp is None else stamp
        with self._lock:
            self._events.append((name, ph, int(device), t, int(nbytes)))

    def _event(self, stream=None):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        if self._origin is None:
            self._origin = ev
        return ev

    def span_begin(self, name: str, *, device: int = 0, nbytes: int = 0) -> None:
        """Record the start of ``name`` here (the values it starts from
        exist: on the CPU now, on a CUDA device when the current stream
        reaches this point)."""
        self._mark(name, "B", nbytes, device, self._event() if self.cuda else None)

    def span_end(self, name: str, *, device: int = 0, nbytes: int = 0, work=None) -> None:
        """Record the end of ``name``: here, or when the asynchronous
        collective ``work`` completes."""
        if work is None:
            self._mark(name, "E", nbytes, device, self._event() if self.cuda else None)
        elif self.cuda:
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream()
            with torch.cuda.stream(self._side_stream):
                work.wait()  # the side stream waits for the collective
                self._mark(name, "E", nbytes, device, self._event(self._side_stream))
        else:
            work.get_future().then(lambda _f: self._mark(name, "E", nbytes, device))

    # -- reading back --------------------------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._origin = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def _resolved(self) -> list[tuple[str, str, int, float, int]]:
        with self._lock:
            events = list(self._events)
            origin = self._origin
        if not self.cuda:
            return events
        for e in events:
            e[3].synchronize()
        return [(n, ph, d, origin.elapsed_time(ev) * 1e6, nb) for n, ph, d, ev, nb in events]

    def spans(self) -> list[Span]:
        """Pair B/E markers into spans (per name × device, FIFO order)."""
        open_: dict[tuple[str, int], list[tuple[float, int]]] = {}
        out: list[Span] = []
        for name, ph, dev, t_ns, nbytes in sorted(self._resolved(), key=lambda e: e[3]):
            key = (name, dev)
            if ph == "B":
                open_.setdefault(key, []).append((t_ns, nbytes))
            else:
                if not open_.get(key):
                    continue  # unmatched end (cleared mid-step)
                t0, b0 = open_[key].pop(0)
                args = {"bytes": max(b0, nbytes)} if (b0 or nbytes) else {}
                out.append(
                    Span(name=name, device=dev, start_us=t0 / 1e3,
                         dur_us=max(0.0, (t_ns - t0) / 1e3), args=args)
                )
        out.sort(key=lambda s: (s.device, s.start_us))
        return out

    def to_chrome_trace(self) -> dict:
        """Chrome-trace dict: one ``ph: "X"`` complete event per span,
        ``pid`` = device — the shape the JAX package's recorder writes, so
        one parser serves both packages' recordings and fixtures."""
        return {
            "displayTimeUnit": "ns",
            "traceEvents": [
                {
                    "name": s.name, "ph": "X", "pid": s.device, "tid": 0,
                    "ts": s.start_us, "dur": s.dur_us, "args": s.args,
                }
                for s in self.spans()
            ],
        }

    def save(self, path) -> None:
        """Write the Chrome trace to ``path`` (gzipped iff it ends .gz)."""
        data = json.dumps(self.to_chrome_trace(), indent=1, sort_keys=True)
        if str(path).endswith(".gz"):
            with gzip.open(path, "wt") as f:
                f.write(data)
        else:
            with open(path, "w") as f:
                f.write(data)


def parse_trace_spans(trace) -> list[Span]:
    """Parse Chrome-trace ``X`` events into :class:`Span` rows.

    ``trace`` is a dict, a JSON string, or a path to ``.json`` /
    ``.json.gz`` — recorded traces of either package, committed
    ``tests/data/`` fixtures, and profiler dumps all funnel through here.
    ``B``/``E`` event pairs are folded into complete spans; events
    without a duration are skipped.  Devices are taken from ``pid``.
    """
    if isinstance(trace, pathlib.PurePath):
        trace = str(trace)
    if isinstance(trace, (str, bytes)) and not str(trace).lstrip().startswith("{"):
        opener = gzip.open if str(trace).endswith(".gz") else open
        with opener(trace, "rt") as f:
            trace = json.load(f)
    elif isinstance(trace, (str, bytes)):
        trace = json.loads(trace)
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) else trace

    spans: list[Span] = []
    open_: dict[tuple[str, int], list[dict]] = {}
    for ev in events:
        ph = ev.get("ph")
        name = ev.get("name")
        if not name:
            continue
        dev = int(ev.get("pid", 0))
        if ph == "X":
            spans.append(
                Span(name=name, device=dev, start_us=float(ev["ts"]),
                     dur_us=float(ev.get("dur", 0.0)), args=dict(ev.get("args", {})))
            )
        elif ph == "B":
            open_.setdefault((name, dev), []).append(ev)
        elif ph == "E":
            stack = open_.get((name, dev))
            if stack:
                b = stack.pop(0)
                spans.append(
                    Span(name=name, device=dev, start_us=float(b["ts"]),
                         dur_us=float(ev["ts"]) - float(b["ts"]),
                         args=dict(b.get("args", {})))
                )
    spans.sort(key=lambda s: (s.device, s.start_us))
    return spans


def _union_len(intervals: list[tuple[float, float]]) -> float:
    total = 0.0
    end = -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _overlap_with_union(lo: float, hi: float, intervals: list[tuple[float, float]]) -> float:
    """Length of [lo, hi] ∩ (∪ intervals)."""
    clipped = [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]
    return _union_len(clipped)


def overlap_report(spans: list[Span]) -> dict:
    """Measured comm/compute overlap from parsed spans.

    Comm spans are the ``wfbp_group{gi}_l{lo}_{hi}`` scopes; backward
    spans are the ``bwd_*`` scopes.  Per device the report intersects
    each comm span with the backward *window* (first backward start ..
    last backward end) and with the union of the backward spans
    themselves; aggregated:

    * ``overlap_fraction`` — Σ comm-time-inside-backward-window / Σ comm
      time: the issue-order property the ``dag`` step buys (``post``
      scores ~0: every group issues after the window closes);
    * ``hidden_fraction`` — the stricter Σ comm-time-intersecting-backward
      spans / Σ comm time: true wall-clock concurrency;
    * ``n_overlapped_starts`` — comm spans starting strictly before the
      device's last backward span ends (a merged all-reduce issued
      *inside* backward);
    * ``groups`` — per-group rows from the first device (name, layers,
      bytes, start/dur, window/hidden time, the starts-before flag).

    Returns zeros (not an error) when no comm spans parse — callers
    assert on the fields, so an empty trace fails loudly there.
    """
    by_dev: dict[int, dict[str, list[Span]]] = {}
    for s in spans:
        d = by_dev.setdefault(s.device, {"comm": [], "bwd": []})
        if GROUP_SPAN_RE.match(s.name):
            d["comm"].append(s)
        elif s.name.startswith(BWD_SPAN_PREFIX):
            d["bwd"].append(s)

    total_comm = hidden = windowed = 0.0
    n_overlapped_starts = 0
    n_comm_spans = 0
    groups_out: list[dict] = []
    first_dev = min(by_dev) if by_dev else None
    for dev in sorted(by_dev):
        comm, bwd = by_dev[dev]["comm"], by_dev[dev]["bwd"]
        bwd_iv = [(s.start_us, s.end_us) for s in bwd]
        first_bwd_start = min((s.start_us for s in bwd), default=0.0)
        last_bwd_end = max((s.end_us for s in bwd), default=0.0)
        window = [(first_bwd_start, last_bwd_end)] if bwd else []
        for s in comm:
            h = _overlap_with_union(s.start_us, s.end_us, bwd_iv)
            w = _overlap_with_union(s.start_us, s.end_us, window)
            starts_inside = bool(bwd) and s.start_us < last_bwd_end
            total_comm += s.dur_us
            hidden += h
            windowed += w
            n_comm_spans += 1
            if starts_inside:
                n_overlapped_starts += 1
            if dev == first_dev:
                m = GROUP_SPAN_RE.match(s.name)
                groups_out.append(
                    {
                        "name": s.name,
                        "group": int(m.group(1)),
                        "layers": [int(m.group(2)), int(m.group(3))],
                        "bytes": int(s.args.get("bytes", 0)),
                        "start_us": s.start_us,
                        "dur_us": s.dur_us,
                        "window_us": w,
                        "hidden_us": h,
                        "starts_before_bwd_end": starts_inside,
                    }
                )
    groups_out.sort(key=lambda g: g["group"])
    return {
        "n_devices": len(by_dev),
        "n_comm_spans": n_comm_spans,
        "n_bwd_spans": sum(len(d["bwd"]) for d in by_dev.values()),
        "total_comm_us": total_comm,
        "windowed_comm_us": windowed,
        "hidden_comm_us": hidden,
        "overlap_fraction": (windowed / total_comm) if total_comm > 0 else 0.0,
        "hidden_fraction": (hidden / total_comm) if total_comm > 0 else 0.0,
        "n_overlapped_starts": n_overlapped_starts,
        "groups": groups_out,
    }
