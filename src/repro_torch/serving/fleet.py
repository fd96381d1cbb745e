"""The serving fleet (counterpart of ``repro/serving/fleet.py``): N
``ServingEngine`` replicas behind one controller.

* **LoadGenerator**: a seeded Poisson or trace arrival schedule; the same
  seed gives the same arrivals, prompts and deadlines (numpy's draws, so
  the JAX generator's too), and a chaos run and its fault-free baseline see
  the same traffic.
* **FleetController**: one ``ServeLoopDriver`` per replica (the
  cooperative ``tick()`` form of ``resilient_serve_loop``, so the fleet and
  the single engine share one failure semantics), heartbeat health checks,
  per-replica seeded chaos domains (``ChaosConfig.for_replica``) and
  SLO-aware admission: a request goes to the live replica with the cheapest
  plan-priced ETA, and is shed fleet-wide when no replica's
  ``ServePlan.predicted_step_time()`` meets its deadline.
* **failover**: a replica whose restore budget is spent (or whose
  heartbeat is stale) is dead; its waiting and active requests drain to
  live peers with their partial output (``Request.replica_id`` /
  ``retries`` record where they went), and resume admission re-prefills the
  prefix, so a failed-over request's output starts with the tokens it had
  and goodput is counted once.
* **FleetWatchdog**: prices the fleet's backlog against
  ``ServePlan.capacity_tok_per_s`` and decides scale-up / scale-down
  (applied when the controller is elastic).

On one card every replica may share one model (one copy of the weights);
each engine has its own caches and, on the card, its own CUDA graph.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib
import time
from typing import Any, Callable

import numpy as np

from ..runtime.fault_tolerance import StragglerMonitor
from .engine import Request, ServingEngine
from .resilience import ChaosConfig, ChaosInjector, ServeLoopDriver, ServeReport

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# LoadGenerator: seeded trace / Poisson arrivals
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One seeded offered-load schedule.

    ``kind='poisson'`` draws exponential gaps at ``rate_rps`` requests a
    second; ``kind='trace'`` replays ``trace_arrivals_s`` (cycled when
    shorter than ``n_requests``).  ``deadline_s`` is each request's SLO
    relative to its own arrival (None: no deadline).  Arrivals and prompts
    are a function of ``seed`` alone."""

    n_requests: int = 16
    prompt_len: int = 8
    max_new_tokens: int = 8
    kind: str = "poisson"
    rate_rps: float = 200.0
    trace_arrivals_s: tuple[float, ...] = ()
    deadline_s: float | None = None
    seed: int = 0
    vocab: int = 256


class LoadGenerator:
    """A materialized ``LoadSpec``: (arrival offset, Request) pairs popped
    in arrival order by ``due(now)``.  Offsets are relative to the fleet
    loop's start; the controller stamps each request's absolute deadline at
    admission."""

    def __init__(self, spec: LoadSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        n = spec.n_requests
        if spec.kind == "trace":
            if not spec.trace_arrivals_s:
                raise ValueError("trace load needs trace_arrivals_s")
            tr = list(spec.trace_arrivals_s)
            span = tr[-1] - tr[0]
            period = max(span + span / max(1, len(tr) - 1), 1e-9)
            offsets = sorted(float(tr[i % len(tr)] + (i // len(tr)) * period)
                             for i in range(n))
        elif spec.kind == "poisson":
            gaps = rng.exponential(1.0 / max(spec.rate_rps, 1e-9), size=n)
            offsets = np.cumsum(gaps).tolist()
        else:
            raise ValueError(f"unknown load kind {spec.kind!r}")
        self._queue: list[tuple[float, Request]] = []
        for rid, off in enumerate(offsets):
            prompt = rng.integers(0, spec.vocab, size=spec.prompt_len, dtype=np.int32)
            self._queue.append((float(off), Request(rid=rid, prompt=prompt,
                                                    max_new_tokens=spec.max_new_tokens)))
        self._next = 0

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self._queue)

    @property
    def next_arrival_s(self) -> float | None:
        """Offset of the next arrival not yet due (None when drained)."""
        if self.exhausted:
            return None
        return self._queue[self._next][0]

    def due(self, now_s: float) -> list[tuple[float, Request]]:
        """Pop every (arrival offset, request) with offset <= ``now_s``."""
        out = []
        while not self.exhausted and self._queue[self._next][0] <= now_s:
            out.append(self._queue[self._next])
            self._next += 1
        return out


# ---------------------------------------------------------------------------
# FleetWatchdog: plan-priced scale decisions
# ---------------------------------------------------------------------------


class FleetWatchdog:
    """Backlog against capacity, priced by the plan.

    A replica's capacity is ``ServePlan.capacity_tok_per_s(slots)``, so the
    drain time of ``backlog_tokens`` over ``n_alive`` replicas is a
    plan-derived quantity, and each decision records the drain prediction
    before and after it.  ``scale_up`` fires when the drain time exceeds
    ``scale_up_backlog_s``; ``scale_down`` after ``scale_down_idle_rounds``
    empty rounds in a row (0 disables); ``cooldown_rounds`` rounds pass
    between decisions."""

    def __init__(self, *, scale_up_backlog_s: float = float("inf"),
                 scale_down_idle_rounds: int = 0, cooldown_rounds: int = 4):
        self.scale_up_backlog_s = scale_up_backlog_s
        self.scale_down_idle_rounds = scale_down_idle_rounds
        self.cooldown_rounds = cooldown_rounds
        self.idle_rounds = 0
        self._cooldown = 0
        self.decisions: list[dict[str, Any]] = []

    def assess(self, *, round_idx: int, backlog_tokens: int, n_alive: int, plan: Any,
               slots: int) -> str | None:
        """One fleet heartbeat: ``'scale_up'`` / ``'scale_down'`` / None,
        with the plan-priced reason recorded."""
        if self._cooldown > 0:
            self._cooldown -= 1
        cap = plan.capacity_tok_per_s(slots) if plan is not None else None
        if not cap:
            return None
        drain_s = backlog_tokens / (cap * max(1, n_alive))
        self.idle_rounds = self.idle_rounds + 1 if backlog_tokens == 0 else 0
        action = None
        if self._cooldown == 0:
            if drain_s > self.scale_up_backlog_s:
                action = "scale_up"
            elif (self.scale_down_idle_rounds > 0
                  and self.idle_rounds >= self.scale_down_idle_rounds and n_alive > 1):
                action = "scale_down"
        if action is not None:
            delta = 1 if action == "scale_up" else -1
            self.decisions.append({
                "round": int(round_idx),
                "action": action,
                "backlog_tokens": int(backlog_tokens),
                "n_alive": int(n_alive),
                "capacity_tok_per_s_per_replica": float(cap),
                "drain_s_before": float(drain_s),
                "drain_s_after": float(backlog_tokens / (cap * max(1, n_alive + delta))),
            })
            self._cooldown = self.cooldown_rounds
            self.idle_rounds = 0
        return action


# ---------------------------------------------------------------------------
# FleetReport
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetReport:
    """What one ``FleetController.run`` did, fleet-wide.

    ``latencies_s`` maps rid -> arrival-to-completion seconds of every
    finished request; ``goodput_tokens`` counts the tokens of completed
    requests neither shed nor expired (a failed-over request is one
    ``Request``, counted once).  ``failover_token_mismatches`` counts
    failed-over requests whose output does not start with the prefix they
    had at failover: it must be 0."""

    completed: dict[int, Request] = dataclasses.field(default_factory=dict)
    latencies_s: dict[int, float] = dataclasses.field(default_factory=dict)
    rounds: int = 0
    offered: int = 0
    shed: int = 0
    expired: int = 0
    failovers: int = 0
    failover_token_mismatches: int = 0
    replica_deaths: int = 0
    restores: int = 0
    replans: int = 0
    snapshots: int = 0
    scale_ups: int = 0
    scale_downs: int = 0
    scale_decisions: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    recovery_times_s: list[float] = dataclasses.field(default_factory=list)
    replicas: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    goodput_tokens: int = 0
    wall_s: float = 0.0

    @property
    def goodput_tok_per_s(self) -> float:
        """Deadline-meeting tokens per wall second over the whole run."""
        return self.goodput_tokens / max(self.wall_s, 1e-9)

    def latency_percentile(self, q: float) -> float:
        """The q-th percentile of completed requests' latency seconds (0
        when none completed); shed requests are left out."""
        vals = [t for rid, t in self.latencies_s.items() if not self.completed[rid].shed]
        return float(np.percentile(vals, q)) if vals else 0.0

    def summary(self) -> dict[str, Any]:
        """The JSON-ready roll-up of one run."""
        done = [r for r in self.completed.values() if not r.shed]
        return {
            "offered": self.offered,
            "completed": len(done),
            "shed": self.shed,
            "expired": self.expired,
            "failovers": self.failovers,
            "failover_token_mismatches": self.failover_token_mismatches,
            "replica_deaths": self.replica_deaths,
            "restores": self.restores,
            "replans": self.replans,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "goodput_tokens": self.goodput_tokens,
            "goodput_tok_per_s": self.goodput_tok_per_s,
            "p50_latency_s": self.latency_percentile(50),
            "p99_latency_s": self.latency_percentile(99),
            "wall_s": self.wall_s,
            "rounds": self.rounds,
        }


# ---------------------------------------------------------------------------
# FleetController
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs of one fleet run.

    ``max_restores`` budgets each replica's in-place recoveries (snapshot
    restores inside its ``ServeLoopDriver``); past it the replica is dead
    and its requests fail over.  ``heartbeat_timeout_s`` declares a replica
    dead when its last good tick is older than this on the fleet clock
    (None disables).  ``elastic`` lets the watchdog's decisions add and
    retire replicas (within ``min_replicas`` / ``max_replicas``); otherwise
    they are recorded only.  ``idle_sleep_s`` is slept when a round makes no
    progress."""

    replicas: int = 4
    snapshot_every: int = 8
    max_restores: int = 1
    backoff_base_s: float = 0.0
    heartbeat_timeout_s: float | None = None
    max_rounds: int = 10_000
    elastic: bool = False
    min_replicas: int = 1
    max_replicas: int = 8
    scale_up_backlog_s: float = float("inf")
    scale_down_idle_rounds: int = 0
    idle_sleep_s: float = 5e-4


@dataclasses.dataclass
class _Replica:
    """The controller's handle on one replica: engine, driver, health."""

    rid: int
    engine: ServingEngine
    driver: ServeLoopDriver
    alive: bool = True
    retired: bool = False  # scale-down, not death
    last_beat_s: float = 0.0
    failed_over: int = 0
    report: ServeReport | None = None


class FleetController:
    """Route, tick, health-check, fail over and (optionally) scale N
    serving replicas.

    ``engine_factory(replica_id)`` builds one ready ``ServingEngine`` (its
    ``ServePlan`` installed); ``config.replicas`` are spawned up front and
    more on an elastic scale-up.  Each replica runs behind its own
    ``ServeLoopDriver`` with its own snapshot directory under
    ``snapshot_root`` and, with ``chaos``, its own fault domain
    (``chaos.for_replica(rid)``, only for ``chaos_replicas`` when given).
    ``clock`` and ``sleep_fn`` are injectable.

    Example::

        fleet = FleetController(
            engine_factory=make_engine,
            config=FleetConfig(replicas=4, max_restores=0),
            snapshot_root=tmpdir,
            chaos=ChaosConfig(kill_at=(3,), max_kills=1),
            chaos_replicas=(0,),
        )
        report = fleet.run(LoadGenerator(LoadSpec(n_requests=16)))
        assert report.failover_token_mismatches == 0
    """

    def __init__(
        self,
        *,
        engine_factory: Callable[[int], ServingEngine],
        config: FleetConfig = FleetConfig(),
        snapshot_root: str,
        clock: Callable[[], float] = time.monotonic,
        sleep_fn: Callable[[float], None] = time.sleep,
        chaos: ChaosConfig | None = None,
        chaos_replicas: tuple[int, ...] | None = None,
        straggler_factory: Callable[[], StragglerMonitor] | None = None,
        refit_time_fn: Callable[[int], float] | None = None,
    ):
        self.engine_factory = engine_factory
        self.config = config
        self.snapshot_root = pathlib.Path(snapshot_root)
        self.clock = clock
        self.sleep_fn = sleep_fn
        self.chaos = chaos
        self.chaos_replicas = chaos_replicas
        self.straggler_factory = straggler_factory
        self.refit_time_fn = refit_time_fn
        self.watchdog = FleetWatchdog(scale_up_backlog_s=config.scale_up_backlog_s,
                                      scale_down_idle_rounds=config.scale_down_idle_rounds)
        self.report = FleetReport()
        self.replicas: list[_Replica] = []
        self.pending: list[Request] = []  # unroutable (no live replica)
        self._arrival_abs: dict[int, float] = {}
        self._failover_prefix: dict[int, tuple[int, ...]] = {}
        self._t0: float | None = None
        for _ in range(config.replicas):
            self._spawn_replica()

    # -- replica lifecycle --------------------------------------------------

    def _spawn_replica(self) -> _Replica:
        rid = len(self.replicas)
        engine = self.engine_factory(rid)
        injector = None
        if self.chaos is not None and (self.chaos_replicas is None
                                       or rid in self.chaos_replicas):
            injector = ChaosInjector(self.chaos.for_replica(rid))
        driver = ServeLoopDriver(
            engine,
            snapshot_dir=str(self.snapshot_root / f"replica_{rid}"),
            snapshot_every=self.config.snapshot_every,
            max_restarts=self.config.max_restores,
            backoff_base_s=self.config.backoff_base_s,
            sleep_fn=self.sleep_fn,
            clock=self.clock,
            chaos=injector,
            straggler=self.straggler_factory() if self.straggler_factory is not None else None,
            refit_time_fn=self.refit_time_fn,
        )
        rep = _Replica(rid=rid, engine=engine, driver=driver, last_beat_s=self.clock())
        self.replicas.append(rep)
        return rep

    def alive_replicas(self) -> list[_Replica]:
        return [r for r in self.replicas if r.alive]

    def _close_replica(self, rep: _Replica) -> None:
        """Final accounting for a replica leaving the fleet (death or
        scale-down): harvest its finished requests, freeze its report."""
        self._drain_completed(rep)
        rep.report = rep.driver.finalize()

    # -- admission / routing ------------------------------------------------

    def _eta_s(self, rep: _Replica, req: Request) -> float:
        """Plan-priced completion ETA of ``req`` on ``rep``: the queue
        ahead of it spread over the replica's slots (plus the shortest
        active row when no slot is free) and its own remaining steps, in
        multiples of ``ServePlan.predicted_step_time()``."""
        plan = rep.engine.plan
        step = plan.predicted_step_time() if plan is not None else None
        if not step:
            return 0.0  # an unpriced engine admits everything
        queued = sum(r.remaining_tokens for r in rep.engine.waiting)
        free = rep.engine.slots - len(rep.engine.active)
        gate = 0
        if free <= 0 and rep.engine.active:
            gate = min(r.remaining_tokens for r in rep.engine.active.values())
        wait_steps = gate + queued / max(1, rep.engine.slots)
        return step * (wait_steps + req.remaining_tokens)

    def route(self, req: Request, now: float) -> bool:
        """Place ``req`` on the live replica with the cheapest ETA; shed it
        fleet-wide when even that misses its deadline.  False when shed or
        deferred (no live replica)."""
        alive = self.alive_replicas()
        if not alive:
            self.pending.append(req)
            return False
        best = min(alive, key=lambda r: self._eta_s(r, req))
        eta = self._eta_s(best, req)
        if req.deadline_s is not None and now + eta > req.deadline_s:
            req.shed = True
            req.done = True
            self._complete(req, now)
            return False
        req.replica_id = best.rid
        best.engine.submit(req)
        return True

    # -- failure handling ---------------------------------------------------

    def _fail_over(self, rep: _Replica, reason: str) -> None:
        """A replica died: drain its waiting and in-flight requests and
        re-route them (``retries`` bumped, the partial prefix recorded so
        completion can check it), their output kept by resume admission."""
        rep.alive = False
        self.report.replica_deaths += 1
        reqs = rep.engine.drain_requests()
        self._close_replica(rep)
        log.warning("fleet: replica %d dead (%s); failing over %d request(s)",
                    rep.rid, reason, len(reqs))
        now = self.clock()
        for req in reqs:
            self._failover_prefix.setdefault(req.rid, tuple(req.generated))
            req.retries += 1
            rep.failed_over += 1
            self.report.failovers += 1
            self.route(req, now)

    def health_check(self) -> None:
        """Heartbeat sweep: a live replica whose last good tick is older
        than ``heartbeat_timeout_s`` is dead and failed over (catches a
        hung replica, not only a raising one)."""
        timeout = self.config.heartbeat_timeout_s
        if timeout is None:
            return
        now = self.clock()
        for rep in self.alive_replicas():
            if now - rep.last_beat_s > timeout:
                self._fail_over(rep, reason="stale heartbeat")

    # -- completion bookkeeping --------------------------------------------

    def _complete(self, req: Request, now: float) -> None:
        if req.rid in self.report.completed:
            return  # by rid: goodput is never counted twice
        self.report.completed[req.rid] = req
        arr = self._arrival_abs.get(req.rid)
        if arr is not None:
            self.report.latencies_s[req.rid] = now - arr
        prefix = self._failover_prefix.get(req.rid)
        if prefix is not None and not req.shed:
            if tuple(req.generated[: len(prefix)]) != prefix:
                self.report.failover_token_mismatches += 1
                log.error("fleet: request %d lost its partial prefix across failover", req.rid)

    def _drain_completed(self, rep: _Replica) -> None:
        now = self.clock()
        for req in rep.engine.completed:
            self._complete(req, now)
        rep.engine.completed.clear()

    # -- elastic scaling ----------------------------------------------------

    def _apply_scale(self, action: str) -> None:
        if action == "scale_up":
            if len(self.alive_replicas()) >= self.config.max_replicas:
                return
            self._spawn_replica()
            self.report.scale_ups += 1
            # re-route the waiting (never admitted) requests, so the new
            # replica takes part of the backlog; active rows stay put
            moved: list[Request] = []
            for rep in self.alive_replicas():
                moved.extend(rep.engine.waiting)
                rep.engine.waiting.clear()
            now = self.clock()
            for req in moved:
                self.route(req, now)
        elif action == "scale_down":
            if len(self.alive_replicas()) <= self.config.min_replicas:
                return
            idle = [r for r in self.alive_replicas()
                    if not r.engine.active and not r.engine.waiting]
            if not idle:
                return  # never retire a busy replica
            rep = idle[-1]
            rep.alive = False
            rep.retired = True
            self._close_replica(rep)
            self.report.scale_downs += 1

    # -- the fleet loop ------------------------------------------------------

    def backlog_tokens(self) -> int:
        """Tokens still owed across every live replica's queues."""
        total = 0
        for rep in self.alive_replicas():
            total += sum(r.remaining_tokens for r in rep.engine.active.values())
            total += sum(r.remaining_tokens for r in rep.engine.waiting)
        return total

    def _tick_replica(self, rep: _Replica) -> bool:
        """One guarded driver tick; a tick that raises past the restore
        budget kills the replica and fails its work over."""
        try:
            progressed = rep.driver.tick()
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            self._fail_over(rep, reason=repr(e))
            return False
        rep.last_beat_s = self.clock()
        return progressed

    def run(self, load: LoadGenerator) -> FleetReport:
        """Serve the whole load to completion (or ``max_rounds``): admit
        due arrivals, tick every live replica one step, sweep heartbeats,
        harvest completions, let the watchdog scale.  The finalized
        ``FleetReport``."""
        cfg = self.config
        self._t0 = t0 = self.clock()
        rounds = 0
        while rounds < cfg.max_rounds:
            now = self.clock()
            # 1. admission: due arrivals and deferred requests
            for off, req in load.due(now - t0):
                self.report.offered += 1
                self._arrival_abs[req.rid] = t0 + off
                if load.spec.deadline_s is not None:
                    req.deadline_s = t0 + off + load.spec.deadline_s
                self.route(req, now)
            if self.pending and self.alive_replicas():
                retry, self.pending = self.pending, []
                for req in retry:
                    self.route(req, now)
            # 2. one step per live replica
            progressed = False
            for rep in list(self.alive_replicas()):
                progressed |= self._tick_replica(rep)
            # 3. liveness, harvest, scaling
            self.health_check()
            for rep in list(self.alive_replicas()):
                self._drain_completed(rep)
            action = self.watchdog.assess(
                round_idx=rounds,
                backlog_tokens=self.backlog_tokens(),
                n_alive=len(self.alive_replicas()),
                plan=next((r.engine.plan for r in self.alive_replicas()
                           if r.engine.plan is not None), None),
                slots=max((r.engine.slots for r in self.alive_replicas()), default=1),
            )
            if action is not None and cfg.elastic:
                self._apply_scale(action)
            rounds += 1
            if (load.exhausted and not self.pending
                    and all(r.driver.idle for r in self.alive_replicas())):
                break
            if not progressed and cfg.idle_sleep_s > 0:
                self.sleep_fn(cfg.idle_sleep_s)
        return self._finalize(rounds)

    def _finalize(self, rounds: int) -> FleetReport:
        out = self.report
        out.rounds = rounds
        for rep in self.replicas:
            if rep.alive:
                self._close_replica(rep)
                rep.alive = False
                rep.retired = True
        for rep in self.replicas:
            r = rep.report
            if r is None:
                continue
            # successful in-place restores only: r.restarts also counts the
            # attempt that spent the budget and killed the replica
            out.restores += len(r.recovery_times_s)
            out.replans += r.replans
            out.snapshots += r.snapshots
            out.recovery_times_s.extend(r.recovery_times_s)
            out.replicas.append({
                "rid": rep.rid,
                "retired": rep.retired,
                "steps": r.steps,
                "restarts": r.restarts,
                "replans": r.replans,
                "failed_over": rep.failed_over,
            })
        out.scale_decisions = list(self.watchdog.decisions)
        done = list(out.completed.values())
        out.shed = sum(1 for r in done if r.shed)
        out.expired = sum(1 for r in done if r.expired)
        out.goodput_tokens = sum(len(r.generated) for r in done
                                 if not r.shed and not r.expired)
        out.wall_s = self.clock() - (self._t0 or 0.0)
        return out
