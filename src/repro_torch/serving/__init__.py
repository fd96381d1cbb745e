"""Serving (counterpart of ``repro/serving``): continuous batching over one
captured decode step (``engine``), the resilience layer (``resilience``:
snapshots and their restore, seeded chaos, the restart serve loop,
deadlines, degraded-fabric replanning) and the fleet (``fleet``: replicas
behind one SLO-aware router, failover, plan-priced elastic scaling) and the
sharded TP decode (``sharded``: the ``ServePlan``'s group collectives
executed in the decode step, and the at-rest DTensor layout)."""

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
from .sharded import (
    make_sharded_decode_step,
    serving_cache_pspecs,
    serving_param_pspecs,
    shard_serving_state,
    stack_fresh_rows,
    write_fresh_rows,
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
    "make_sharded_decode_step",
    "resilient_serve_loop",
    "restore_latest_snapshot",
    "save_snapshot",
    "serving_cache_pspecs",
    "serving_param_pspecs",
    "shard_serving_state",
    "snapshot_engine",
    "stack_fresh_rows",
    "write_fresh_rows",
    "write_snapshot",
]
