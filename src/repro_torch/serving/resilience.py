"""Serving resilience (counterpart of ``repro/serving/resilience.py``):
snapshots and their restore, seeded chaos, the restart loop, deadlines and
shedding, and degraded-fabric re-planning.

* **EngineSnapshot**: the engine's decode state (the cache tree, row
  positions, next tokens, the active mask and budgets), the states of both
  sampling generators (the step's and admission's: the counterparts of the
  JAX snapshot's two PRNG keys), the host mirrors and every request queue,
  written through ``checkpoint.save`` (atomic rename).
  ``ServingEngine.restore_snapshot`` resumes decoding token for token.
* **ChaosInjector**: seeded faults at the engine's seams: a kill raised
  before a step, step and collective times scaled on a degraded fabric, a
  corrupted snapshot and a write killed mid-flight.  Its draws are numpy's,
  so one seed gives the JAX injector's schedule.
* **ServeLoopDriver** / **resilient_serve_loop**: restart with backoff
  around ``engine.step()``: restore the newest snapshot that loads (a
  corrupt one falls back to an older one), re-warm the step, resume.
  Deadlines retire active rows past them with their partial output, and
  shed waiting requests whose predicted completion misses them.
* **degraded-fabric replan**: a ``StragglerMonitor`` over step times; on
  sustained slow steps the serve (α, β) is re-fitted
  (``planning.refit_serve_fit``) and the plan rebuilt
  (``planning.rebuild_serve_plan``).

Where the port differs, and why:

* On disk a snapshot is ``tensors.bin`` plus a manifest.  That file has no
  check of its own (the JAX snapshot's ``leaves.npz`` has the zip CRC), so
  ``write_snapshot`` records a ``zlib.crc32`` of every tensor's bytes in the
  manifest and ``load_snapshot`` reads into host tensors and verifies each
  one before anything touches an engine.  The cache tree's ``(k, v, kpos)``
  tuples are stored as dicts keyed ``"0"``, ``"1"``, ``"2"``.
* A restore copies into the engine's own tensors (``copy_``): a captured
  CUDA graph replays over the buffers it recorded, so rebinding them would
  leave the replay decoding the old ones.  The step's generator is
  registered with the graph, and ``set_state`` on it moves the state the
  replays read.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch

from ..checkpoint import available_steps, latest_step, restore, save
from ..models.transformer import tree_map
from ..runtime.fault_tolerance import StragglerMonitor
from .engine import Request, ServingEngine

log = logging.getLogger(__name__)

SNAPSHOT_FORMAT = 1
_DATA = "tensors.bin"  # the checkpoint's data file, what a bad disk corrupts


# ---------------------------------------------------------------------------
# EngineSnapshot: the whole serving state, on the host
# ---------------------------------------------------------------------------


def _req_to_dict(r: Request) -> dict[str, Any]:
    return {
        "rid": int(r.rid),
        "prompt": [int(t) for t in np.asarray(r.prompt).tolist()],
        "max_new_tokens": int(r.max_new_tokens),
        "generated": [int(t) for t in r.generated],
        "done": bool(r.done),
        "deadline_s": None if r.deadline_s is None else float(r.deadline_s),
        "expired": bool(r.expired),
        "shed": bool(r.shed),
        "replica_id": None if r.replica_id is None else int(r.replica_id),
        "retries": int(r.retries),
    }


def _req_from_dict(d: dict[str, Any]) -> Request:
    return Request(
        rid=int(d["rid"]),
        prompt=np.asarray(d["prompt"], np.int32),
        max_new_tokens=int(d["max_new_tokens"]),
        generated=[int(t) for t in d["generated"]],
        done=bool(d["done"]),
        deadline_s=d.get("deadline_s"),
        expired=bool(d.get("expired", False)),
        shed=bool(d.get("shed", False)),
        replica_id=d.get("replica_id"),
        retries=int(d.get("retries", 0)),
    )


@dataclasses.dataclass
class EngineSnapshot:
    """One resumable serving checkpoint, entirely on the host.

    ``state`` is the engine's decode state copied to CPU tensors (the cache
    tree with its tuples, ``row_pos``, ``next_token``, ``active``,
    ``budget``); ``gen_state`` / ``admit_gen_state`` are the uint8 states of
    the step's and admission's sampling generators; the three request
    collections are JSON dicts; ``row_pos`` / ``next_token`` are the host
    mirrors; ``meta`` pins the engine's geometry (``arch`` / ``slots`` /
    ``max_seq``), so a restore into another engine fails loudly."""

    step: int
    state: dict
    gen_state: torch.Tensor
    admit_gen_state: torch.Tensor
    active: dict[int, dict]
    waiting: list[dict]
    completed: list[dict]
    row_pos: np.ndarray
    next_token: np.ndarray
    meta: dict[str, Any]

    def validate_against(self, engine: ServingEngine) -> None:
        """Raise unless ``engine`` has the geometry this snapshot was taken
        under (same arch, slots and max_seq)."""
        want = _engine_meta(engine)
        got = {k: self.meta.get(k) for k in want}
        if got != want:
            raise ValueError(f"snapshot geometry {got} does not match engine {want}")

    @property
    def nbytes(self) -> int:
        """Bytes of the tensors the snapshot holds (what a write stores)."""
        return sum(t.numel() * t.element_size() for _, t in _flat(_disk_tree(self)))


def _engine_meta(engine: ServingEngine) -> dict[str, Any]:
    return {"arch": engine.cfg.name, "slots": int(engine.slots), "max_seq": int(engine.max_seq)}


def snapshot_engine(engine: ServingEngine, step: int = 0) -> EngineSnapshot:
    """Copy the engine's decode state, generator states and request queues
    to host memory; safe between any two steps."""
    state = tree_map(lambda t: t.to("cpu", copy=True), engine._state)
    return EngineSnapshot(
        step=int(step),
        state=state,
        gen_state=engine._gen.get_state(),
        admit_gen_state=engine._admit_gen.get_state(),
        active={int(s): _req_to_dict(r) for s, r in engine.active.items()},
        waiting=[_req_to_dict(r) for r in engine.waiting],
        completed=[_req_to_dict(r) for r in engine.completed],
        row_pos=np.asarray(engine.row_pos, np.int32).copy(),
        next_token=np.asarray(engine.next_token, np.int32).copy(),
        meta={"serve_snapshot_format": SNAPSHOT_FORMAT, **_engine_meta(engine)},
    )


def requests_from_snapshot(
    snap: EngineSnapshot,
) -> tuple[dict[int, Request], list[Request], list[Request]]:
    """Rebuild the three request collections from a snapshot (fresh
    ``Request`` objects: a restored run never aliases the caller's)."""
    active = {int(s): _req_from_dict(d) for s, d in snap.active.items()}
    waiting = [_req_from_dict(d) for d in snap.waiting]
    completed = [_req_from_dict(d) for d in snap.completed]
    return active, waiting, completed


def _tuples_to_dicts(tree):
    """The cache tree in ``checkpoint``'s form: each tuple a dict keyed by
    its positions."""
    if isinstance(tree, dict):
        return {k: _tuples_to_dicts(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {str(i): _tuples_to_dicts(v) for i, v in enumerate(tree)}
    return tree


def _dicts_to_tuples(tree, like):
    """Back from ``_tuples_to_dicts``, with ``like``'s tuples."""
    if isinstance(like, tuple):
        return tuple(_dicts_to_tuples(tree[str(i)], v) for i, v in enumerate(like))
    if isinstance(like, dict):
        return {k: _dicts_to_tuples(tree[k], v) for k, v in like.items()}
    return tree


def _disk_tree(snap: EngineSnapshot) -> dict:
    return {"state": _tuples_to_dicts(snap.state), "gen": snap.gen_state,
            "admit_gen": snap.admit_gen_state}


def _flat(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(checkpoint path, tensor) of every tensor of a dict tree."""
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out += _flat(value, f"{prefix}{key}/")
        else:
            out.append((prefix + key, value))
    return out


def _crc(t: torch.Tensor) -> int:
    """CRC-32 of a host tensor's bytes, as ``tensors.bin`` stores them."""
    return zlib.crc32(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def write_snapshot(snap: EngineSnapshot, directory: str) -> pathlib.Path:
    """Persist ``snap`` under ``directory/step_<k>/`` through
    ``checkpoint.save`` (atomic rename: a crash mid-write leaves the older
    snapshots whole), with a CRC-32 of every tensor in the manifest."""
    tree = _disk_tree(snap)
    return save(directory, snap.step, tree, extra={
        "meta": snap.meta,
        "step": snap.step,
        "active": {str(s): d for s, d in snap.active.items()},
        "waiting": snap.waiting,
        "completed": snap.completed,
        "row_pos": snap.row_pos.tolist(),
        "next_token": snap.next_token.tolist(),
        "crc32": {path: _crc(t) for path, t in _flat(tree)},
    })


def save_snapshot(engine: ServingEngine, directory: str, step: int) -> EngineSnapshot:
    """Snapshot the engine and persist it (``snapshot_engine`` then
    ``write_snapshot``)."""
    snap = snapshot_engine(engine, step)
    write_snapshot(snap, directory)
    return snap


def load_snapshot(directory: str, step: int, engine: ServingEngine) -> EngineSnapshot:
    """Read one on-disk snapshot into host tensors shaped as ``engine``'s
    and verify every tensor's CRC-32.  Raises ``ValueError`` on a corrupt,
    truncated or mismatched snapshot, having touched no engine tensor
    (``restore_latest_snapshot`` catches it and falls back)."""
    host_state = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), engine._state)
    like = {"state": _tuples_to_dicts(host_state), "gen": engine._gen.get_state(),
            "admit_gen": engine._admit_gen.get_state()}
    _, extra = restore(directory, step, like)
    meta = extra.get("meta", {})
    if meta.get("serve_snapshot_format") != SNAPSHOT_FORMAT:
        raise ValueError(
            f"unsupported serve snapshot format {meta.get('serve_snapshot_format')!r}")
    crcs = extra.get("crc32", {})
    for path, t in _flat(like):
        if crcs.get(path) != _crc(t):
            raise ValueError(f"serve snapshot step {step}: {path} fails its CRC-32 check")
    return EngineSnapshot(
        step=int(extra["step"]),
        state=_dicts_to_tuples(like["state"], host_state),
        gen_state=like["gen"],
        admit_gen_state=like["admit_gen"],
        active={int(s): d for s, d in extra["active"].items()},
        waiting=list(extra["waiting"]),
        completed=list(extra["completed"]),
        row_pos=np.asarray(extra["row_pos"], np.int32),
        next_token=np.asarray(extra["next_token"], np.int32),
        meta=meta,
    )


def latest_snapshot(directory: str) -> int | None:
    """Step of the newest complete on-disk snapshot (None when empty)."""
    return latest_step(directory)


def restore_latest_snapshot(engine: ServingEngine, directory: str) -> tuple[int, int]:
    """Restore the newest *loadable* snapshot into ``engine``.

    Walks the complete snapshots newest first; a corrupt one (a CRC-32
    mismatch, a truncated file, a geometry mismatch) is logged and skipped.
    Returns ``(restored_step, skipped)``; raises ``RuntimeError`` when none
    loads."""
    skipped = 0
    for step in reversed(available_steps(directory)):
        try:
            snap = load_snapshot(directory, step, engine)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            log.exception("snapshot step %d unloadable; falling back", step)
            skipped += 1
            continue
        engine.restore_snapshot(snap)
        return step, skipped
    raise RuntimeError(f"no loadable serve snapshot in {directory!r} ({skipped} corrupt)")


# ---------------------------------------------------------------------------
# ChaosInjector: deterministic, seeded fault injection
# ---------------------------------------------------------------------------


class ChaosError(RuntimeError):
    """An injected failure: what the chaos step-raise seam throws."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault schedule for one chaos run.

    ``kill_every`` / ``kill_at`` raise deterministically (each step kills at
    most once, so a restored run replaying the step makes progress);
    ``kill_prob`` draws a seeded Bernoulli per attempted step (bounded by
    ``max_kills``).  ``slow_factor`` / ``slow_after`` model a degraded
    fabric: observed step times and probed collective times are multiplied
    once the loop passes ``slow_after``.  ``corrupt_snapshot_at`` overwrites
    bytes of the newest snapshot's data file after the first snapshot at or
    after that step; ``partial_write_at`` leaves a manifest-less
    ``step_<k>.tmp`` directory (a write killed mid-flight)."""

    seed: int = 0
    kill_every: int = 0
    kill_at: tuple[int, ...] = ()
    kill_prob: float = 0.0
    max_kills: int | None = None
    slow_factor: float = 1.0
    slow_after: int | None = None
    corrupt_snapshot_at: int | None = None
    partial_write_at: int | None = None

    def for_replica(self, replica_id: int) -> "ChaosConfig":
        """Replica ``replica_id``'s fault domain: the schedule fields
        shared, the seed drawn from ``(seed, replica_id)`` by
        ``np.random.SeedSequence``, so the whole fleet replays from one
        seed."""
        derived = int(np.random.SeedSequence([int(self.seed), int(replica_id)])
                      .generate_state(1)[0])
        return dataclasses.replace(self, seed=derived)


class ChaosInjector:
    """Deterministic executor of a ``ChaosConfig``: the step-raise seam
    (``fault_injector(step)``, the contract of
    ``runtime.fault_tolerance.resilient_loop``), step-time scaling,
    collective-probe wrapping, snapshot corruption and the mid-write
    kill."""

    def __init__(self, config: ChaosConfig):
        self.config = config
        self.rng = np.random.default_rng(config.seed)
        self.kills = 0
        self._killed_steps: set[int] = set()
        self._corrupted = False
        self._partial = False

    # -- step-raise seam ----------------------------------------------------

    def fault_injector(self, step: int) -> None:
        """Raise ``ChaosError`` when the schedule kills this step (each
        step kills at most once)."""
        c = self.config
        if self.kills_exhausted():
            return
        due = (step in c.kill_at) or (c.kill_every > 0 and step > 0 and step % c.kill_every == 0)
        if not due and c.kill_prob > 0:
            due = bool(self.rng.random() < c.kill_prob)
        if due and step not in self._killed_steps:
            self._killed_steps.add(step)
            self.kills += 1
            raise ChaosError(f"injected kill at serve step {step}")

    def kills_exhausted(self) -> bool:
        c = self.config
        return c.max_kills is not None and self.kills >= c.max_kills

    # -- degraded-fabric seams ----------------------------------------------

    def degraded(self, step: int) -> bool:
        c = self.config
        return c.slow_factor != 1.0 and c.slow_after is not None and step >= c.slow_after

    def scale_step_time(self, dt: float, step: int) -> float:
        """Observed step seconds under chaos: times ``slow_factor`` once
        the fabric is degraded (what the ``StragglerMonitor`` sees)."""
        return dt * self.config.slow_factor if self.degraded(step) else dt

    def wrap_time_fn(self, time_fn: Callable[[int], float],
                     step_fn: Callable[[], int]) -> Callable[[int], float]:
        """Wrap a ``time_fn(nbytes) -> seconds`` collective probe so it
        reports degraded times once the fabric is slow (the seam
        ``refit_serve_fit`` probes through)."""

        def wrapped(nbytes: int) -> float:
            t = float(time_fn(nbytes))
            return t * self.config.slow_factor if self.degraded(step_fn()) else t

        return wrapped

    # -- snapshot seams -----------------------------------------------------

    def post_snapshot(self, directory: str, step: int) -> None:
        """Apply the snapshot faults once their step arrives (the loop
        calls this right after each snapshot lands)."""
        c = self.config
        if c.corrupt_snapshot_at is not None and step >= c.corrupt_snapshot_at \
                and not self._corrupted:
            self._corrupted = True
            self.corrupt_snapshot(directory)
        if c.partial_write_at is not None and step >= c.partial_write_at and not self._partial:
            self._partial = True
            self.partial_write(directory, step + 1)

    def corrupt_snapshot(self, directory: str, step: int | None = None) -> None:
        """Overwrite 64 seeded bytes in the middle of the newest (or given)
        snapshot's ``tensors.bin``: a bad disk.  The CRC-32 check makes the
        next load raise, and the restore falls back to an older snapshot."""
        step = latest_step(directory) if step is None else step
        if step is None:
            return
        path = pathlib.Path(directory) / f"step_{step:08d}" / _DATA
        size = path.stat().st_size
        if size < 128:
            return
        with open(path, "r+b") as f:
            f.seek(size // 2)
            f.write(bytes(self.rng.integers(0, 256, 64, np.uint8)))
        log.warning("chaos: corrupted snapshot step %d (%s)", step, path)

    def partial_write(self, directory: str, step: int) -> None:
        """Leave a manifest-less ``step_<k>.tmp`` directory behind: what a
        process killed mid-write leaves.  No reader may take it for a
        snapshot."""
        tmp = pathlib.Path(directory) / f"step_{step:08d}.tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        (tmp / _DATA).write_bytes(bytes(self.rng.integers(0, 256, 256, np.uint8)))
        log.warning("chaos: left partial snapshot write %s", tmp)


# ---------------------------------------------------------------------------
# resilient_serve_loop: restart with backoff around engine.step()
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeReport:
    """What one ``resilient_serve_loop`` run did.

    ``shed`` / ``expired`` are final request states, counted once each;
    ``recovery_times_s`` holds one entry per restart (backoff + restore +
    re-warm); ``goodput_tokens`` counts the tokens of completed requests
    that met their deadline."""

    completed: list[Request] = dataclasses.field(default_factory=list)
    steps: int = 0
    restarts: int = 0
    replans: int = 0
    snapshots: int = 0
    snapshot_fallbacks: int = 0
    shed: int = 0
    expired: int = 0
    recovery_times_s: list[float] = dataclasses.field(default_factory=list)
    interrupted: bool = False
    goodput_tokens: int = 0
    wall_s: float = 0.0

    @property
    def goodput_tok_per_s(self) -> float:
        """Deadline-meeting tokens per wall second over the whole run."""
        return self.goodput_tokens / max(self.wall_s, 1e-9)


def _expire_and_shed(engine: ServingEngine, now: float, report: ServeReport) -> None:
    """Deadlines at both ends: active rows past theirs retire with their
    partial output; waiting requests whose predicted completion misses
    theirs are shed before they cost a step."""
    pred = engine.predicted_step_time() or 0.0
    for slot, req in list(engine.active.items()):
        if req.deadline_s is not None and now >= req.deadline_s:
            engine.retire(slot, expired=True)
    kept = []
    for req in engine.waiting:
        if req.deadline_s is not None:
            eta = now + pred * (req.max_new_tokens + 1)
            if now >= req.deadline_s or eta > req.deadline_s:
                req.shed = True
                req.done = True
                engine.completed.append(req)
                continue
        kept.append(req)
    engine.waiting[:] = kept


def _degraded_replan(
    engine: ServingEngine,
    baseline_model: Any,
    chaos: ChaosInjector | None,
    refit_time_fn: Callable[[int], float] | None,
    refit_sizes: tuple[int, ...] | None,
    step: int,
    on_replan: Callable[[Any], None] | None,
) -> None:
    """Re-fit the serve (α, β) and rebuild the plan at the degraded
    constants.  The default probe prices the loop-entry plan's model (under
    a chaos slowdown that is the degraded wire; probing the baseline, never
    the previous fit, keeps repeated replans from compounding)."""
    from ..planning.serve import rebuild_serve_plan, refit_serve_fit

    plan = engine.plan
    if plan is None:
        return
    time_fn = refit_time_fn or (lambda nb: float(baseline_model(nb)))
    if chaos is not None:
        time_fn = chaos.wrap_time_fn(time_fn, lambda: step)
    fit = refit_serve_fit(time_fn, probe_sizes=refit_sizes,
                          name=f"degraded:{plan.model.name or plan.fabric}")
    new_plan = rebuild_serve_plan(plan, fit)
    engine.install_plan(new_plan)
    log.warning(
        "degraded-fabric replan at step %d: (a=%.3e, b=%.3e) -> (a=%.3e, b=%.3e), "
        "%d -> %d groups", step, plan.model.a, plan.model.b, fit.a, fit.b,
        len(plan.schedule.groups), len(new_plan.schedule.groups),
    )
    if on_replan is not None:
        on_replan(new_plan)


class ServeLoopDriver:
    """The resilient serve loop, one guarded step at a time.

    ``tick()`` advances one step and survives a failure by backoff +
    snapshot restore + re-warm.  ``resilient_serve_loop`` is the
    single-engine loop over one driver; ``serving.fleet.FleetController``
    ticks N of them round-robin, so both share one failure semantics.  A
    tick that spends ``max_restarts`` (or finds no loadable snapshot)
    re-raises: the fleet's cue to fail the replica's requests over."""

    def __init__(
        self,
        engine: ServingEngine,
        *,
        snapshot_dir: str,
        snapshot_every: int = 8,
        max_restarts: int = 5,
        backoff_base_s: float = 0.05,
        sleep_fn: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        chaos: ChaosInjector | None = None,
        straggler: StragglerMonitor | None = None,
        refit_time_fn: Callable[[int], float] | None = None,
        refit_sizes: tuple[int, ...] | None = None,
        on_replan: Callable[[Any], None] | None = None,
    ):
        self.engine = engine
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.sleep_fn = sleep_fn
        self.clock = clock
        self.chaos = chaos
        self.straggler = straggler
        self.refit_time_fn = refit_time_fn
        self.refit_sizes = refit_sizes
        self.on_replan = on_replan
        self.report = ServeReport()
        self.step = 0
        self.restarts = 0
        self._baseline_model = engine.plan.model if engine.plan is not None else None
        self._t_start = clock()
        # one snapshot before the first step: a kill at any point has one to restore
        self.snapshot_now()

    @property
    def idle(self) -> bool:
        """No active rows and no waiting requests: nothing to tick."""
        return not self.engine.active and not self.engine.waiting

    def snapshot_now(self) -> None:
        """Persist the engine at the current step (counted)."""
        save_snapshot(self.engine, self.snapshot_dir, self.step)
        self.report.snapshots += 1

    def tick(self) -> bool:
        """Advance one guarded serve step; False once no work remains.  A
        failure inside the step recovers in place unless the restart budget
        is spent, when it propagates."""
        if self.idle:
            return False
        try:
            _expire_and_shed(self.engine, self.clock(), self.report)
            if self.idle:
                return False
            if self.chaos is not None:
                self.chaos.fault_injector(self.step)
            t0 = self.clock()
            self.engine.step()
            dt = self.clock() - t0
            self.step += 1
            self.report.steps += 1
            if self.chaos is not None:
                dt = self.chaos.scale_step_time(dt, self.step)
            if self.straggler is not None and self.straggler.observe(dt):
                _degraded_replan(self.engine, self._baseline_model, self.chaos,
                                 self.refit_time_fn, self.refit_sizes, self.step,
                                 self.on_replan)
                self.report.replans += 1
            if self.step % max(1, self.snapshot_every) == 0:
                self.snapshot_now()
                if self.chaos is not None:
                    self.chaos.post_snapshot(self.snapshot_dir, self.step)
        except (KeyboardInterrupt, SystemExit):
            save_snapshot(self.engine, self.snapshot_dir, self.step)
            raise  # an operator's interrupt stops the loop, never restarts it
        except Exception:
            self._recover()
        return True

    def _recover(self) -> None:
        """Restart with backoff from the newest loadable snapshot (inside
        the failed tick's ``except``; re-raises the failure once
        ``max_restarts`` is spent)."""
        log.exception("serve step %d failed; restart %d/%d from latest snapshot",
                      self.step, self.restarts + 1, self.max_restarts)
        self.restarts += 1
        self.report.restarts = self.restarts
        if self.restarts > self.max_restarts:
            raise
        t_fail = self.clock()
        if self.backoff_base_s > 0:
            self.sleep_fn(self.backoff_base_s * 2 ** (self.restarts - 1))
        restored, skipped = restore_latest_snapshot(self.engine, self.snapshot_dir)
        self.report.snapshot_fallbacks += skipped
        self.engine.warmup()  # builds the step only if it was never built
        self.step = restored
        self.report.recovery_times_s.append(self.clock() - t_fail)

    def finalize(self) -> ServeReport:
        """Close the report: wall time, completed requests, the shed /
        expired / goodput tallies."""
        report = self.report
        report.wall_s = self.clock() - self._t_start
        report.completed = list(self.engine.completed)
        report.shed = sum(1 for r in report.completed if r.shed)
        report.expired = sum(1 for r in report.completed if r.expired)
        report.goodput_tokens = sum(len(r.generated) for r in report.completed
                                    if not r.shed and not r.expired)
        return report


def resilient_serve_loop(
    engine: ServingEngine,
    *,
    snapshot_dir: str,
    snapshot_every: int = 8,
    max_restarts: int = 5,
    max_steps: int = 10_000,
    backoff_base_s: float = 0.05,
    sleep_fn: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    chaos: ChaosInjector | None = None,
    straggler: StragglerMonitor | None = None,
    refit_time_fn: Callable[[int], float] | None = None,
    refit_sizes: tuple[int, ...] | None = None,
    on_replan: Callable[[Any], None] | None = None,
    stop_flag: Callable[[], bool] | None = None,
) -> ServeReport:
    """Run ``engine`` to completion, surviving failures.

    One snapshot before the first step and one every ``snapshot_every``
    steps.  On a step failure: log, back off (``backoff_base_s *
    2**(restarts-1)`` through ``sleep_fn``), restore the newest loadable
    snapshot (``snapshot_fallbacks`` counts the corrupt ones skipped),
    re-warm, resume; the completed tokens equal an unbroken run's.
    ``KeyboardInterrupt`` / ``SystemExit`` snapshot and re-raise;
    ``stop_flag`` (``launch/serve.py`` sets it on SIGINT) snapshots and
    stops cleanly.  Deadlines and the degraded-fabric replan as
    ``ServeLoopDriver.tick``; every time is read from ``clock``, so a test
    can make deadlines deterministic."""
    driver = ServeLoopDriver(
        engine,
        snapshot_dir=snapshot_dir,
        snapshot_every=snapshot_every,
        max_restarts=max_restarts,
        backoff_base_s=backoff_base_s,
        sleep_fn=sleep_fn,
        clock=clock,
        chaos=chaos,
        straggler=straggler,
        refit_time_fn=refit_time_fn,
        refit_sizes=refit_sizes,
        on_replan=on_replan,
    )
    while driver.step < max_steps:
        if stop_flag is not None and stop_flag():
            driver.snapshot_now()
            driver.report.interrupted = True
            break
        if not driver.tick():
            break
    return driver.finalize()
