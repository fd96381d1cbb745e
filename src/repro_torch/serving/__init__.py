"""Serving (counterpart of ``repro/serving``): continuous batching over one
captured decode step (``engine``), the resilience layer (``resilience``:
snapshots and their restore, seeded chaos, the restart serve loop,
deadlines, degraded-fabric replanning) and the fleet (``fleet``: replicas
behind one SLO-aware router, failover, plan-priced elastic scaling).

Sharded TP decode (``sharded``, ROADMAP A.3.1) is still to port."""

from .engine import Request, ServeTimer, ServingEngine, greedy, gumbel_sampler
from .fleet import (
    FleetConfig,
    FleetController,
    FleetReport,
    FleetWatchdog,
    LoadGenerator,
    LoadSpec,
)
from .resilience import (
    ChaosConfig,
    ChaosError,
    ChaosInjector,
    EngineSnapshot,
    ServeLoopDriver,
    ServeReport,
    latest_snapshot,
    load_snapshot,
    resilient_serve_loop,
    restore_latest_snapshot,
    save_snapshot,
    snapshot_engine,
    write_snapshot,
)

__all__ = [
    "ChaosConfig",
    "ChaosError",
    "ChaosInjector",
    "EngineSnapshot",
    "FleetConfig",
    "FleetController",
    "FleetReport",
    "FleetWatchdog",
    "LoadGenerator",
    "LoadSpec",
    "Request",
    "ServeLoopDriver",
    "ServeReport",
    "ServeTimer",
    "ServingEngine",
    "greedy",
    "gumbel_sampler",
    "latest_snapshot",
    "load_snapshot",
    "resilient_serve_loop",
    "restore_latest_snapshot",
    "save_snapshot",
    "snapshot_engine",
    "write_snapshot",
]
