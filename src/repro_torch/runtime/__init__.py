"""The runtime of the live training loop (counterpart of
``repro/runtime``): the fault-tolerant loop and straggler detection,
gradient compression with error feedback, per-unit probes and step
timing."""

from .compression import (
    ErrorFeedbackState,
    bf16_ef_decode,
    bf16_ef_encode,
    compressed_psum_rs_ag,
    compressed_psum_rs_ag_ref,
    ef_init,
)
from .fault_tolerance import RunState, StragglerMonitor, agreed_latest_step, resilient_loop
from .timeline import (
    BWD_FRACTION,
    StepTimer,
    UnitProfile,
    make_unit_probes,
    probe_unit_times,
    time_group_comm,
)

__all__ = [
    "RunState",
    "StragglerMonitor",
    "agreed_latest_step",
    "resilient_loop",
    "ErrorFeedbackState",
    "bf16_ef_decode",
    "bf16_ef_encode",
    "compressed_psum_rs_ag",
    "compressed_psum_rs_ag_ref",
    "ef_init",
    "BWD_FRACTION",
    "StepTimer",
    "UnitProfile",
    "make_unit_probes",
    "probe_unit_times",
    "time_group_comm",
]
