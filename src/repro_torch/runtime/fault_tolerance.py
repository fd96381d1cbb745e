"""Fault tolerance: the restart loop and straggler detection (counterpart
of ``repro/runtime/fault_tolerance.py``).

The logic (what to do when) is deterministic and unit-tested; the signal
sources are injectable callables, so tests simulate failures exactly.

* ``resilient_loop``: run train steps; on a failure restore the latest
  complete checkpoint and continue.  A checkpoint mid-write is never
  read (the atomic rename keeps the older one complete).
* ``StragglerMonitor``: a step slower than ``factor`` x the rolling
  median flags a straggler; ``patience`` flags in a row request
  remediation.  Merged buckets make all-reduces fewer and larger, so one
  slow rank stalls the whole step.
* elasticity: the ``on_restart`` hook runs after every restore; the
  launcher restores the stored plan there, or re-plans for the world it
  now has (``checkpoint.restore_rebucketed``).

The state is the live one.  ``RunState`` points at the tensors the train
step updates in place, and a restore copies the checkpoint into them.
Its ``opt_state.step``, a plain int that AdamW's bias correction reads,
is set on the same ``OptState`` object.

Several ranks (one process each, the default process group) share one
loop:

* only rank 0 writes;
* the error-feedback residual is per-rank state, so at every save each
  rank's residual is gathered to rank 0 and stored as ``(world,
  *shape)``, and at a restore each rank takes its own row.  A restart at
  another world size fails the shape check;
* before ``latest_step`` is read, every rank waits until rank 0's rename
  is done (a barrier), and every rank restores rank 0's latest step.

Neither the gather, the barrier nor that broadcast goes through the
counted ``issue()`` seam: they move no gradient.

A fault must hit every rank at the same step.  ``fault_injector(step)``
is a function of the step, so it does.  A fault on one rank alone leaves
the others in a collective that never completes: surviving it needs a
new process group (torchrun's elastic agent), which is out of scope.
"""

from __future__ import annotations

import dataclasses
import logging
import statistics
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..checkpoint import AsyncCheckpointer, latest_step
from ..optim.optimizers import OptState

log = logging.getLogger(__name__)

Tensors = dict[str, torch.Tensor]


@dataclasses.dataclass
class RunState:
    """The training state a checkpoint holds: the next step's index, the
    live parameters and optimizer state, the restart count and the
    residual."""

    step: int
    params: Tensors
    opt_state: OptState
    restarts: int = 0
    #: error-feedback residual (compression='bf16_ef'), per rank; None for
    #: stateless runs.  Checkpointed beside params/opt_state so EF
    #: compression survives restarts.
    residual: Tensors | None = None

    def checkpoint_tree(self) -> dict:
        opt = self.opt_state
        tree = {"params": self.params,
                "opt_state": {"step": opt.step, "m": opt.m, "v": opt.v}}
        if self.residual is not None:
            tree["residual"] = self.residual
        return tree


class StragglerMonitor:
    """Deadline-based straggler detection on per-step wall times."""

    def __init__(self, factor: float = 2.0, patience: int = 3, window: int = 32):
        self.factor = factor
        self.patience = patience
        self.window = window
        self.durations: list[float] = []
        self.consecutive_slow = 0
        self.remediations = 0

    def observe(self, duration_s: float) -> bool:
        """Record one step; returns True when remediation should trigger."""
        if len(self.durations) >= 8:
            med = statistics.median(self.durations[-self.window:])
            if duration_s > self.factor * med:
                self.consecutive_slow += 1
            else:
                self.consecutive_slow = 0
        self.durations.append(duration_s)
        if self.consecutive_slow >= self.patience:
            self.consecutive_slow = 0
            self.remediations += 1
            return True
        return False


def _rank_world() -> tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def agreed_latest_step(directory) -> int | None:
    """Rank 0's ``latest_step(directory)`` on every rank, read once every
    rank has reached this call (so rank 0's renames are done)."""
    rank, world = _rank_world()
    if world == 1:
        return latest_step(directory)
    dist.barrier()
    box = [latest_step(directory) if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _saved_tree(state: RunState, rank: int, world: int) -> dict | None:
    """The tree rank 0 writes (None on the other ranks): ``state``'s, with
    every rank's residual gathered into ``(world, *shape)`` rows."""
    tree = state.checkpoint_tree()
    if state.residual is None:
        return tree if rank == 0 else None
    rows = {}
    for name, t in state.residual.items():
        if world == 1:
            rows[name] = t.unsqueeze(0)
            continue
        out = torch.empty((world, *t.shape), dtype=t.dtype, device=t.device) if rank == 0 \
            else None
        dist.gather(t.contiguous(), list(out.unbind(0)) if rank == 0 else None, dst=0)
        rows[name] = out
    tree["residual"] = rows
    return tree if rank == 0 else None


def _restore(ckpt: AsyncCheckpointer, step: int, state: RunState, rank: int,
             world: int) -> dict:
    """Checkpoint ``step`` into ``state``'s live tensors, this rank's row
    of the residual included; returns the checkpoint's ``extra``."""
    like = state.checkpoint_tree()
    if state.residual is not None:
        like["residual"] = {n: torch.empty((world, *t.shape), dtype=t.dtype)
                            for n, t in state.residual.items()}
    tree, extra = ckpt.restore(step, like)
    state.opt_state.step = tree["opt_state"]["step"]
    if state.residual is not None:
        with torch.no_grad():
            for n, t in state.residual.items():
                t.copy_(tree["residual"][n][rank])
    return extra


def resilient_loop(
    *,
    num_steps: int,
    init_state: Callable[[], RunState],
    train_step: Callable[[RunState, int], RunState],
    checkpoint_dir: str,
    checkpoint_every: int = 50,
    max_restarts: int = 5,
    backoff_base_s: float = 0.05,
    sleep_fn: Callable[[float], None] = time.sleep,
    fault_injector: Callable[[int], None] | None = None,
    straggler: StragglerMonitor | None = None,
    on_straggler: Callable[[RunState], RunState] | None = None,
    on_restart: Callable[[RunState], RunState] | None = None,
    plan_provider: Callable[[], Any] | None = None,
    tuner_provider: Callable[[], Any] | None = None,
    checkpointer: AsyncCheckpointer | None = None,
) -> RunState:
    """Checkpoint/restart training loop.

    ``fault_injector(step)`` may raise to simulate a node failure; the
    loop restores the latest complete checkpoint and resumes.  The data
    pipeline needs no state file: batches are pure functions of the step
    (``data/pipeline.py``), so a restored step restores the stream.

    ``init_state()`` gives step 0's state; it is called at the start and
    before every restore (a restart with no checkpoint resumes from it).
    ``on_restart(state)`` runs after every restore, from scratch too: the
    hook where the launcher rebuilds its train step under the stored plan
    or re-plans.

    Failure handling: every failure logs the full traceback with the
    failing step before the restore; ``KeyboardInterrupt`` /
    ``SystemExit`` are never swallowed (an operator's Ctrl-C stops the
    run); restarts back off exponentially (``backoff_base_s *
    2**(restarts-1)``, ``sleep_fn`` injectable so tests pin the schedule
    without sleeping); and the ``restarts`` counter saved in every
    checkpoint's ``extra`` is folded back in on restore, so the count,
    and the ``max_restarts`` budget, survive process death.  Any other
    exception is retried, a CUDA error too: a caller that must see the
    first fault checks ``restarts`` of the returned state.

    ``plan_provider()`` returns the plan in effect (or None) and
    ``tuner_provider()`` the tuner state; both are called at every save,
    so the plan and the tuner's history land beside the weights.
    ``checkpointer`` writes and restores (a new ``AsyncCheckpointer`` on
    ``checkpoint_dir`` when None); its ``records`` time each save and
    restore.
    """
    rank, world = _rank_world()
    ckpt = checkpointer if checkpointer is not None else AsyncCheckpointer(checkpoint_dir)
    state = init_state()
    restarts = 0

    while state.step < num_steps:
        try:
            t0 = time.monotonic()
            if fault_injector is not None:
                fault_injector(state.step)
            state = train_step(state, state.step)
            state.step += 1
            dt = time.monotonic() - t0
            if straggler is not None and straggler.observe(dt):
                if on_straggler is not None:
                    state = on_straggler(state)
            if state.step % checkpoint_every == 0:
                tree = _saved_tree(state, rank, world)
                if rank == 0:
                    ckpt.save(
                        state.step, tree,
                        extra={"restarts": restarts},
                        plan=plan_provider() if plan_provider is not None else None,
                        tuner=tuner_provider() if tuner_provider is not None else None,
                    )
        except (KeyboardInterrupt, SystemExit):
            raise  # operator interrupts stop the run, never restart it
        except Exception:
            log.exception(
                "train step %d failed; restart %d/%d from latest checkpoint",
                state.step, restarts + 1, max_restarts,
            )
            restarts += 1
            if restarts > max_restarts:
                raise
            if backoff_base_s > 0:
                sleep_fn(backoff_base_s * 2 ** (restarts - 1))
            ckpt.wait()
            step = agreed_latest_step(checkpoint_dir)
            state = init_state()
            if step is not None:
                extra = _restore(ckpt, step, state, rank, world)
                # restart counts survive process death: the checkpoint's
                # saved counter (+1 for the failure just handled) floors this
                # process's count, so max_restarts budgets the run, not the
                # process
                restarts = max(restarts, int(extra.get("restarts", 0)) + 1)
                state.step = step
            state.restarts = restarts
            if on_restart is not None:
                state = on_restart(state)
    ckpt.wait()
    if world > 1:
        dist.barrier()  # rank 0's last write is complete on every rank's return
    state.restarts = restarts
    return state
