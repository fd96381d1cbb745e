"""The deterministic discrete-event core of the what-if simulator
(counterpart of ``repro/sim/events.py``).

The simulator replays the plan lifecycle (gradient readiness, merged
all-reduce issue, decode steps) as an event-driven timeline, so
heterogeneous fleets (per-host straggler multipliers, elastic shrink and
grow, replica kills) come out of the same machinery that reproduces
``core.timeline.evaluate`` exactly in the homogeneous case.

Events are ordered by ``(time, seq)``, ``seq`` being the push order: ties
at one instant fire in insertion order, never by payload or hash order, so
one seed gives one trace.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled occurrence: ``kind`` at simulated ``time`` seconds.

    ``payload`` carries the kind's data (host, group, replica, request);
    ``seq`` is the queue's tiebreak, so two events at one instant fire in
    push order."""

    time: float
    kind: str
    payload: dict[str, Any]
    seq: int = 0


class EventQueue:
    """Min-heap of :class:`Event` ordered by ``(time, seq)``.

    ``pop`` refuses an event in the past (a simulator fault, not a race);
    the ``pushed`` / ``popped`` counters give the event volume."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = 0
        self.now = 0.0
        self.pushed = 0
        self.popped = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time: float, kind: str, **payload: Any) -> Event:
        """Schedule ``kind`` at ``time``; returns the queued event."""
        if time < 0.0:
            raise ValueError(f"event {kind!r} scheduled at negative time {time}")
        ev = Event(time=float(time), kind=kind, payload=payload, seq=self._seq)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        self._seq += 1
        self.pushed += 1
        return ev

    def pop(self) -> Event:
        """The next event in ``(time, seq)`` order; advances ``now``."""
        if not self._heap:
            raise IndexError("pop from empty EventQueue")
        time, _, ev = heapq.heappop(self._heap)
        if time < self.now - 1e-15:
            raise RuntimeError(
                f"event {ev.kind!r} at t={time} fires before now={self.now}"
            )
        self.now = max(self.now, time)
        self.popped += 1
        return ev
