"""Per-unit step instrumentation: the live-loop side of measured costs
(counterpart of ``repro/runtime/timeline.py``).

The paper seeds Algorithm 1 with per-layer backward times "benchmarked in
the first several iterations"; the journal version re-derives them online.
A whole-step wall time can only rescale the analytic vector uniformly; it
never moves the *relative* unit costs the merge decision depends on.

``make_unit_probes`` builds one probe per distinct CommUnit kind (embed /
one stage / tail / head) that runs that unit's real forward+backward at
the training shape, and ``probe_unit_times`` times them (warm-up
discarded, min of repeats; the device synchronized before each clock
read).  Structurally identical stages share one probe, so a probe pass
costs three or four calls regardless of depth.  The result feeds
``MeasuredCosts.from_segment_times`` directly.

A probe never touches the live step: it runs on detached copies of one
unit's parameters (``copy.deepcopy`` of its modules, which carries no
gradient hooks) and takes its gradients with ``torch.autograd.grad``, so
no ``.grad`` is written, no hook of the ``dag`` step fires and nothing is
packed or issued.  It runs the unit as the step does: a stage's sublayers
under the same activation checkpointing, the head through
``ce_from_hidden`` (chunked at a vocab of 64k and more).

The comm side rides the same cadence: ``time_group_comm`` times one real
all-reduce per schedule group's wire payload, and ``StepTimer`` owns the
whole-step samples that predicted-vs-observed provenance compares
against.
"""

from __future__ import annotations

import copy
import dataclasses
import statistics
from typing import Any, Callable

import torch
from torch.nn import functional as F

from ..core.profiler import time_segment
from ..models.transformer import ce_from_hidden, run_sublayer
from ..planning.costs import MeasuredComm

#: Probes time forward+backward together; the backward share of a train
#: segment is 2/3 under the paper's 2:4 fwd:bwd flops ratio (Eq. 17/18).
BWD_FRACTION = 2.0 / 3.0


@dataclasses.dataclass
class UnitProfile:
    """One probe pass: measured per-unit backward seconds (+ comm)."""

    unit_seconds: dict[str, float]  # unit name -> backward seconds
    group_seconds: tuple[float, ...] = ()  # per schedule group comm seconds
    source: str = "probe"

    def ratios(self, base_costs, hw) -> dict[str, float]:
        """measured / analytic backward-time ratio per unit — the drift
        signature.  A uniform whole-step rescale produces identical
        ratios; real unit timing does not."""
        out = {}
        for c in base_costs:
            if c.name in self.unit_seconds:
                out[c.name] = self.unit_seconds[c.name] / max(c.t_b(hw), 1e-12)
        return out

    def nonuniformity(self, base_costs, hw) -> float:
        """max/min of the per-unit ratios (1.0 == a pure uniform rescale)."""
        r = list(self.ratios(base_costs, hw).values())
        if not r:
            return 1.0
        return max(r) / max(min(r), 1e-12)


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(True)


def make_unit_probes(cfg, model, batch: dict) -> dict[str, tuple[Callable, tuple]]:
    """One fwd+bwd probe per distinct unit kind of ``model`` (a
    ``models.Transformer``) at ``batch``'s shape.

    Returns ``{kind: (fn, args)}`` with kinds ``embed``, ``stage``,
    ``tail`` (when the arch has one) and ``head``; ``fn(*args)`` returns
    the unit's parameter (and input) gradients.
    """
    targets = batch["targets"]
    B, S = targets.shape
    device = model.embed.device
    x = torch.ones((B, S, cfg.d_model), dtype=cfg.param_dtype, device=device, requires_grad=True)
    positions = torch.arange(S, device=device)[None, :].expand(B, S)
    if cfg.attention is not None and cfg.attention.rope == "mrope":
        positions = positions[None].expand(3, B, S)
    remat = cfg.remat == "full"
    embed = _leaf(model.embed)  # the embed probe's, and the tied head's, copy

    if cfg.input_mode == "embeds":
        # no lookup backward in this mode: the unit's cost is the input cast, as in JAX
        def embed_fn(e):
            with torch.enable_grad():
                return torch.autograd.grad(e.float().sum(), (e,))

        probes: dict[str, tuple[Callable, tuple]] = {
            "embed": (embed_fn, (_leaf(batch["embeds"]),))}
    else:
        tokens = batch["tokens"]

        def embed_fn(e):
            with torch.enable_grad():
                y = F.embedding(tokens, e).to(cfg.param_dtype)
                if cfg.tie_embeddings:
                    y = y * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.param_dtype, device=device)
                return torch.autograd.grad(y.float().sum(), (e,))

        probes = {"embed": (embed_fn, (embed,))}

    def stage_probe(subs):
        subs = copy.deepcopy(subs)  # detached copies; gradient hooks are not copied
        params = tuple(subs.parameters())

        def fn(xx):
            with torch.enable_grad():
                y = xx
                for sub in subs.values():
                    y, _ = run_sublayer(sub, y, positions, remat)
                return torch.autograd.grad(y.float().sum(), (*params, xx))

        return fn

    probes["stage"] = (stage_probe(model.stages[0]), (x,))
    if cfg.tail_pattern:
        probes["tail"] = (stage_probe(model.tail), (x,))

    norm = copy.deepcopy(model.final_norm)
    head_w = embed if cfg.tie_embeddings else _leaf(model.head)

    def head_fn(hw, xx):
        with torch.enable_grad():
            head = hw.T.to(cfg.param_dtype) if cfg.tie_embeddings else hw
            loss = ce_from_hidden(cfg, head, norm(xx), targets)
            return torch.autograd.grad(loss, (*norm.parameters(), hw))

    probes["head"] = (head_fn, (head_w, x))
    return probes


def probe_unit_times(
    cfg, model, batch: dict, layout, *,
    probes: dict[str, tuple[Callable, tuple]] | None = None,
    repeats: int = 2, warmup: int = 1, bwd_fraction: float = BWD_FRACTION,
) -> UnitProfile:
    """Time the unit probes and expand to a per-CommUnit seconds map.

    ``layout`` is the plan's ``ParamLayout``; every ``stage_i`` unit gets
    the (single) stage probe's time — the stages are structurally
    identical — while the embed / tail / head units carry their own.
    Ready to feed ``MeasuredCosts.from_segment_times``.  Pass a prebuilt
    ``probes`` dict (``make_unit_probes``) when probing repeatedly, so the
    parameter copies are made once.
    """
    if probes is None:
        probes = make_unit_probes(cfg, model, batch)
    device = model.embed.device
    kind_seconds = {
        kind: bwd_fraction * time_segment(fn, *args, warmup=warmup, repeats=repeats,
                                          device=device)
        for kind, (fn, args) in probes.items()
    }
    unit_seconds: dict[str, float] = {}
    for u in layout.units:
        kind = "stage" if u.name.startswith("stage_") else u.name
        if kind in kind_seconds:
            unit_seconds[u.name] = kind_seconds[kind]
    return UnitProfile(unit_seconds=unit_seconds, source="probe")


def time_group_comm(
    group, group_nbytes, dtype: torch.dtype = torch.float32, repeats: int = 2,
    device: Any = "cpu",
) -> tuple[float, ...]:
    """Seconds per schedule group's all-reduce on ``group`` (the default
    process group when None): one timed all-reduce per group wire payload
    (backward issue order)."""
    sizes = tuple(max(1, int(n)) for n in group_nbytes)
    mc = MeasuredComm.time_psums(
        group, sizes_bytes=sizes, dtype=dtype, repeats=repeats, name="group_comm",
        device=device,
    )
    return mc.times_s


class StepTimer:
    """Whole-step wall-time window with warm-up-step skipping.

    The train loop calls ``skip(n)`` after anything that rebuilds the step
    (a re-plan) and ``observe(dt)`` per step; ``median()`` is the observed
    t_iter that predicted-vs-observed provenance compares against
    (``Tuner.observe``).

    ``clock`` is injectable (the FakeClock pattern) and drives the
    ``start()``/``stop()`` convenience pair, so timing tests never sleep
    or race real wall clocks."""

    def __init__(self, window: int = 50, skip_first: int = 2, clock: Callable[[], float] | None = None):
        import time as _time

        self.window = window
        self.clock = clock or _time.monotonic
        self._samples: list[float] = []
        self._skip = max(0, skip_first)
        self._t0: float | None = None

    def start(self) -> None:
        """Arm the injected clock for one step (pair with ``stop``)."""
        self._t0 = self.clock()

    def stop(self) -> float:
        """Observe and return the step seconds since ``start()``."""
        if self._t0 is None:
            raise ValueError("StepTimer.stop() before start()")
        dt = self.clock() - self._t0
        self._t0 = None
        self.observe(dt)
        return dt

    def skip(self, n: int = 2) -> None:
        """Discard the next ``n`` samples (a rebuilt step ahead)."""
        self._skip = max(self._skip, n)

    def observe(self, dt: float) -> None:
        if self._skip > 0:
            self._skip -= 1
            return
        self._samples.append(float(dt))
        if len(self._samples) > self.window:
            del self._samples[: -self.window]

    def reset(self, skip_first: int = 2) -> None:
        self._samples.clear()
        self._skip = max(0, skip_first)

    def __len__(self) -> int:
        return len(self._samples)

    def median(self) -> float | None:
        """Median observed step seconds (None before any clean sample)."""
        if not self._samples:
            return None
        return statistics.median(self._samples)
