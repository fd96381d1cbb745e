"""The what-if simulator: replay the plan lifecycle without hardware
(counterpart of ``repro/sim``).

The paper validated MG-WFBP at 64 nodes by trace-based simulation; this
package does the same from the repository's own inputs: the fabric cost
models (presets or measured α–β fits), per-unit compute costs (analytic,
or probed on the card), ``Plan`` / ``ServePlan`` artifacts and the seeded
fleet traffic.  A deterministic discrete-event simulator
(``events`` / ``replay``) replays backward-pass gradient readiness,
merged-group all-reduce issue under any registered policy, and serve-side
decode steps over hypothetical fleets described by a ``ClusterSpec``
(``cluster``): up to 512 hosts, two-tier hierarchies, stragglers, elastic
shrink / grow and replica kills.

``calibrate`` anchors every extrapolation to the committed benchmark
records within a 1.25x budget, and ``report`` freezes the
scaling-efficiency curves into a byte-deterministic ``SimReport``.  It is
host-side Python over numpy: no tensor, no device.

Entry point: ``python -m repro_torch.launch.simulate``.
"""

from .calibrate import (
    DEFAULT_RATIO_BUDGET,
    CalibrationReport,
    CalibrationRow,
    calibrate_serve,
    calibrate_train,
)
from .cluster import MAX_HOSTS, ClusterEvent, ClusterSpec
from .events import Event, EventQueue
from .replay import (
    ServeSimResult,
    SimIteration,
    TrainReplayResult,
    replay_serve,
    replay_train,
    simulate_train_iteration,
)
from .report import SimReport, SimRow, row_from_replay

__all__ = [
    "CalibrationReport",
    "CalibrationRow",
    "ClusterEvent",
    "ClusterSpec",
    "DEFAULT_RATIO_BUDGET",
    "Event",
    "EventQueue",
    "MAX_HOSTS",
    "ServeSimResult",
    "SimIteration",
    "SimReport",
    "SimRow",
    "TrainReplayResult",
    "calibrate_serve",
    "calibrate_train",
    "replay_serve",
    "replay_train",
    "row_from_replay",
    "simulate_train_iteration",
]
