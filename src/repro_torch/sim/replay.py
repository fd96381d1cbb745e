"""Event-driven replay of the plan lifecycle over a ``ClusterSpec``
(counterpart of ``repro/sim/replay.py``).

Three layers, all on the same :class:`~repro_torch.sim.events.EventQueue`:

* :func:`simulate_train_iteration`: one S-SGD iteration as a DAG of
  events (Shi et al., arXiv 1805.03812).  Every host emits one
  gradient-ready event per schedule group as its (straggler-scaled)
  backward pass crosses the group's lowest layer; a group's merged
  all-reduce issues once all hosts are ready and the one serialized comm
  channel is free, in backward order: ``core.timeline.evaluate``'s
  semantics.  With homogeneous multipliers the trace is ``evaluate``'s,
  float for float, which is what the calibration leans on.

* :func:`replay_train`: many iterations over an elastic fleet.  Each
  ``ClusterEvent`` changes the alive-host count, the fabric re-prices the
  all-reduce at the new geometry, and the policy re-plans.

* :func:`replay_serve`: decode steps over N simulated replicas driven by
  the seeded ``serving.fleet.LoadGenerator`` traffic: plan-priced
  min-ETA routing, slot-bound admission at step boundaries, deadline
  shedding, and failover of a killed replica's requests with their
  progress kept: the fleet controller's semantics without the engines.

Nothing here touches a device; the arithmetic is the JAX package's, in
its order, so both packages give the same floats.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from ..core.cost_model import TPU_V5E, Hardware, LayerCost
from ..core.timeline import GroupTrace, comm_avail_times
from ..planning.registry import build_schedule
from .cluster import ClusterSpec
from .events import EventQueue


# ---------------------------------------------------------------------------
# One training iteration as a discrete-event timeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimIteration:
    """The event-driven timeline of one simulated S-SGD iteration.

    ``t_f`` / ``t_b`` are the baseline (multiplier 1) compute times;
    ``t_compute`` is the slowest host's scaled forward + backward, so with
    stragglers an iteration can end on compute.  In the homogeneous case
    every field equals ``core.timeline.evaluate``'s."""

    t_iter: float
    t_f: float
    t_b: float
    t_compute: float
    t_comm_total: float
    t_comm_exposed: float
    groups: tuple[GroupTrace, ...]
    n_events: int

    @property
    def scaling_efficiency(self) -> float:
        """Per-worker weak-scaling efficiency S(N)/N = (t_f + t_b)/t_iter
        (paper Eq. 4), against the baseline compute time."""
        return (self.t_f + self.t_b) / self.t_iter

    def speedup(self, n: int) -> float:
        """S(N) = N (t_f + t_b) / t_iter (paper Eq. 4)."""
        return n * self.scaling_efficiency


def simulate_train_iteration(
    groups: Sequence[tuple[int, int]],
    costs: list[LayerCost],
    ar_model,
    hw: Hardware = TPU_V5E,
    t_f: float | None = None,
    multipliers: Sequence[float] = (1.0,),
    mode: str = "overlap",
) -> SimIteration:
    """Replay one iteration of a merged-group schedule event by event.

    Host ``h`` runs forward + backward scaled by ``multipliers[h]`` and
    emits one ready event per group when the group's lowest layer's
    gradient lands; a group's merged all-reduce starts at ``max(all hosts
    ready, channel free)``, in backward order on one serialized channel.
    ``multipliers=(1.0,) * n`` gives ``core.timeline.evaluate``'s floats.

    ``mode`` is the issue-order model (``core.timeline.MODES``): under
    ``serialized`` each host's ready events fire at the end of its scaled
    backward pass, the post-backward step."""
    if not multipliers:
        raise ValueError("need at least one host multiplier")
    if any(m < 1.0 for m in multipliers):
        raise ValueError(f"multipliers must be >= 1, got {multipliers}")
    if t_f is None:
        t_f = sum(c.t_f(hw) for c in costs)
    t_b_total = sum(c.t_b(hw) for c in costs)
    avail = comm_avail_times(costs, hw, t_f, mode)

    order = list(reversed(list(groups)))  # backward (descending) issue order
    nbytes = [
        sum(costs[i - 1].grad_bytes for i in range(lo, hi + 1)) for lo, hi in order
    ]

    q = EventQueue()
    for gi, (lo, _hi) in enumerate(order):
        for h, m in enumerate(multipliers):
            q.push(m * avail[lo], "host_grad", host=h, group=gi)

    pending = [len(multipliers)] * len(order)  # hosts not yet ready, per group
    ready_at = [0.0] * len(order)
    traces: list[GroupTrace] = []
    channel_free = 0.0
    next_issue = 0
    while len(q):
        ev = q.pop()
        gi = ev.payload["group"]
        pending[gi] -= 1
        ready_at[gi] = max(ready_at[gi], ev.time)
        # issue every group whose turn has come and whose hosts are all ready
        while next_issue < len(order) and pending[next_issue] == 0:
            lo, hi = order[next_issue]
            t_avail = ready_at[next_issue]
            start = max(channel_free, t_avail)
            finish = start + ar_model(nbytes[next_issue])
            traces.append(GroupTrace((lo, hi), nbytes[next_issue], t_avail, start, finish))
            channel_free = finish
            next_issue += 1

    t_compute = max(m * (t_f + t_b_total) for m in multipliers)
    t_iter = max(traces[-1].finish, t_compute)
    return SimIteration(
        t_iter=t_iter,
        t_f=t_f,
        t_b=t_b_total,
        t_compute=t_compute,
        t_comm_total=sum(tr.finish - tr.start for tr in traces),
        t_comm_exposed=t_iter - t_compute,
        groups=tuple(traces),
        n_events=q.popped,
    )


# ---------------------------------------------------------------------------
# Elastic multi-iteration train replay
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainReplayResult:
    """The per-iteration trace of one (policy, cluster) train replay.

    ``iterations`` rows carry ``{iter, n_alive, n_groups, t_iter_s,
    t_compute_s, t_comm_exposed_s, efficiency, replanned}``;
    ``n_replans`` counts elastic re-plans after iteration 0 and
    ``n_kills`` the hosts lost to ``kill`` events."""

    policy: str
    cluster: dict[str, Any]
    iterations: tuple[dict[str, Any], ...]
    n_replans: int
    n_kills: int

    @property
    def mean_t_iter(self) -> float:
        return sum(r["t_iter_s"] for r in self.iterations) / len(self.iterations)

    @property
    def mean_efficiency(self) -> float:
        return sum(r["efficiency"] for r in self.iterations) / len(self.iterations)


def replay_train(
    cluster: ClusterSpec,
    costs: list[LayerCost],
    policy: str,
    *,
    hw: Hardware = TPU_V5E,
    n_iters: int = 1,
    t_f: float | None = None,
    policy_opts: dict[str, Any] | None = None,
) -> TrainReplayResult:
    """Replay ``n_iters`` S-SGD iterations of ``policy`` over ``cluster``.

    Whenever a scripted event changes the alive-host count, the all-reduce
    is re-priced at the new two-tier geometry and the policy re-plans.  A
    function of its inputs: one spec, one trace.  ``policy_opts`` may carry
    ``mode`` (``core.timeline.MODES``), which then drives both the
    re-planning and each iteration's replay."""
    mode = (policy_opts or {}).get("mode", "overlap")
    iterations: list[dict[str, Any]] = []
    n_alive_prev = -1
    schedule = None
    n_replans = 0
    kills_total = 0
    for i in range(max(1, int(n_iters))):
        n_alive, kills_total = cluster.alive_after(i)
        replanned = n_alive != n_alive_prev
        if replanned:
            ar = cluster.ar_model(n_alive)
            schedule = build_schedule(
                policy, costs, ar, hw=hw, t_f=t_f, **(policy_opts or {})
            )
            if i > 0:
                n_replans += 1
            n_alive_prev = n_alive
        it = simulate_train_iteration(
            schedule.groups,
            costs,
            ar,
            hw=hw,
            t_f=t_f,
            multipliers=cluster.straggler_multipliers(n_alive),
            mode=mode,
        )
        iterations.append(
            {
                "iter": i,
                "n_alive": n_alive,
                "n_groups": len(schedule.groups),
                "t_iter_s": it.t_iter,
                "t_compute_s": it.t_compute,
                "t_comm_exposed_s": it.t_comm_exposed,
                "efficiency": it.scaling_efficiency,
                "replanned": replanned and i > 0,
            }
        )
    return TrainReplayResult(
        policy=policy,
        cluster=cluster.to_json_dict(),
        iterations=tuple(iterations),
        n_replans=n_replans,
        n_kills=kills_total,
    )


# ---------------------------------------------------------------------------
# Serve-side replay: decode steps over simulated replicas
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeSimResult:
    """The outcome of one simulated fleet serve run.

    ``duration_s`` is the last completion instant; ``tokens_per_s`` is the
    emitted tokens over that span: steady-state decode throughput, with
    admission and prefill unpriced (see ``sim.calibrate``)."""

    completed: int
    shed: int
    lost: int
    failovers: int
    steps: int
    tokens_emitted: int
    duration_s: float
    latencies_s: tuple[float, ...]

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_emitted / self.duration_s if self.duration_s > 0 else 0.0

    def latency_percentile(self, pct: float) -> float:
        """Completion-latency percentile (0 when nothing completed)."""
        if not self.latencies_s:
            return 0.0
        xs = sorted(self.latencies_s)
        idx = min(len(xs) - 1, max(0, round(pct / 100.0 * (len(xs) - 1))))
        return xs[idx]

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "completed": self.completed,
            "shed": self.shed,
            "lost": self.lost,
            "failovers": self.failovers,
            "steps": self.steps,
            "tokens_emitted": self.tokens_emitted,
            "duration_s": self.duration_s,
            "tokens_per_s": self.tokens_per_s,
            "p50_s": self.latency_percentile(50),
            "p99_s": self.latency_percentile(99),
        }


@dataclasses.dataclass
class _Replica:
    step_s: float
    slots: int
    alive: bool = True
    busy: bool = False
    active: dict[int, int] = dataclasses.field(default_factory=dict)
    queue: list[int] = dataclasses.field(default_factory=list)

    def backlog_tokens(self, remaining: dict[int, int]) -> int:
        return sum(remaining[r] for r in self.active) + sum(
            remaining[r] for r in self.queue
        )


def replay_serve(
    load,
    step_s: float,
    *,
    n_replicas: int = 1,
    slots: int = 2,
    multipliers: Sequence[float] | None = None,
    kill_at_s: dict[int, float] | None = None,
) -> ServeSimResult:
    """Simulate decode serving of a seeded load over ``n_replicas``.

    ``load`` is a ``serving.fleet.LoadSpec`` (or a ``LoadGenerator``), the
    same seeded traffic the real fleet replays.  ``step_s`` is the decode
    step's seconds (``ServePlan.predicted_step_time()``, or a measured
    step), scaled per replica by ``multipliers``.  Requests route to the
    alive replica with the cheapest ETA (backlog tokens x step), are shed
    when their deadline cannot be met, join the ``slots`` decode rows at
    step boundaries, and fail over with their progress kept when
    ``kill_at_s`` kills their replica mid-run."""
    from ..serving.fleet import LoadGenerator, LoadSpec

    if isinstance(load, LoadSpec):
        load = LoadGenerator(load)
    if step_s <= 0:
        raise ValueError(f"step_s must be > 0, got {step_s}")
    mults = tuple(multipliers) if multipliers else (1.0,) * n_replicas
    if len(mults) != n_replicas:
        raise ValueError(f"need {n_replicas} multipliers, got {len(mults)}")
    deadline = load.spec.deadline_s

    replicas = [_Replica(step_s=step_s * m, slots=slots) for m in mults]
    remaining: dict[int, int] = {}
    arrival: dict[int, float] = {}
    latencies: list[float] = []
    completed = shed = lost = failovers = steps = tokens = 0
    last_done = 0.0

    q = EventQueue()
    for off, req in load.due(float("inf")):
        q.push(off, "arrival", rid=req.rid, tokens=req.max_new_tokens)
    for rep_id, t_kill in sorted((kill_at_s or {}).items()):
        q.push(t_kill, "kill", replica=int(rep_id))

    def eta_s(rep: _Replica, rid: int) -> float:
        return rep.step_s * (rep.backlog_tokens(remaining) + remaining[rid])

    def route(rid: int, now: float) -> None:
        nonlocal shed, lost
        alive = [(i, r) for i, r in enumerate(replicas) if r.alive]
        if not alive:
            lost += 1
            return
        best_i, best = min(alive, key=lambda ir: (eta_s(ir[1], rid), ir[0]))
        if deadline is not None and eta_s(best, rid) > deadline:
            shed += 1
            return
        best.queue.append(rid)
        pump(best_i, now)

    def pump(i: int, now: float) -> None:
        """Admit queued requests into free slots at a step boundary (never
        mid-step: a row joining a step in flight would get a free token)
        and keep the replica stepping."""
        rep = replicas[i]
        if not rep.alive or rep.busy:
            return
        while rep.queue and len(rep.active) < rep.slots:
            rid = rep.queue.pop(0)
            rep.active[rid] = remaining[rid]
        if rep.active and not rep.busy:
            rep.busy = True
            q.push(now + rep.step_s, "step", replica=i)

    while len(q):
        ev = q.pop()
        now = ev.time
        if ev.kind == "arrival":
            rid = ev.payload["rid"]
            remaining[rid] = int(ev.payload["tokens"])
            arrival[rid] = now
            route(rid, now)
        elif ev.kind == "kill":
            rep = replicas[ev.payload["replica"]]
            if not rep.alive:
                continue
            rep.alive = False
            stranded = list(rep.active) + rep.queue
            rep.active.clear()
            rep.queue.clear()
            for rid in stranded:  # progress kept: ``remaining`` stands
                failovers += 1
                route(rid, now)
        elif ev.kind == "step":
            i = ev.payload["replica"]
            rep = replicas[i]
            rep.busy = False
            if not rep.alive:
                continue  # the kill beat the step in flight; its tokens are lost
            steps += 1
            for rid in list(rep.active):
                remaining[rid] -= 1
                tokens += 1
                if remaining[rid] == 0:
                    del rep.active[rid]
                    latencies.append(now - arrival[rid])
                    completed += 1
                    last_done = max(last_done, now)
            pump(i, now)

    return ServeSimResult(
        completed=completed,
        shed=shed,
        lost=lost,
        failovers=failovers,
        steps=steps,
        tokens_emitted=tokens,
        duration_s=last_done,
        latencies_s=tuple(latencies),
    )
