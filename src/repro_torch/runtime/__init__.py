"""Runtime instrumentation of the live training loop (counterpart of
``repro/runtime``): per-unit probes and step timing.  The fault-tolerant
loop and the compression module are not ported yet."""

from .timeline import (
    BWD_FRACTION,
    StepTimer,
    UnitProfile,
    make_unit_probes,
    probe_unit_times,
    time_group_comm,
)

__all__ = [
    "BWD_FRACTION",
    "StepTimer",
    "UnitProfile",
    "make_unit_probes",
    "probe_unit_times",
    "time_group_comm",
]
