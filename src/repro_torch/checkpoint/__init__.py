"""Atomic, async checkpoints of named tensors, with the plan and the
tuner state beside them."""

from .checkpoint import (
    AsyncCheckpointer,
    available_steps,
    latest_step,
    load_plan,
    load_tuner_state,
    restore,
    restore_rebucketed,
    save,
)

__all__ = [
    "AsyncCheckpointer",
    "available_steps",
    "latest_step",
    "load_plan",
    "load_tuner_state",
    "restore",
    "restore_rebucketed",
    "save",
]
