"""The hypothetical fleet: the frozen ``ClusterSpec`` (counterpart of
``repro/sim/cluster.py``).

A ``ClusterSpec`` is to the simulator what a mesh is to the launcher: a
JSON record of the fleet a what-if run prices.  It holds the host count
(up to :data:`MAX_HOSTS`), the two-tier hierarchy (``ici_size`` hosts per
fast-tier domain, the rest on the ``'pod'`` axis), the fabric preset that
prices the collectives, seeded per-host straggler multipliers, and a
scripted list of elastic :class:`ClusterEvent`\\ s (shrink / grow / kill).

Everything is a function of the spec's fields: two equal specs simulate
identically, and their JSON is the JAX package's, byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

import numpy as np

#: The largest fleet a spec may describe.
MAX_HOSTS = 512

CLUSTER_SPEC_FORMAT = 1


@dataclasses.dataclass(frozen=True)
class ClusterEvent:
    """One scripted elastic transition, applied before iteration ``at_iter``.

    ``kind='shrink'`` removes ``count`` hosts, ``kind='grow'`` adds
    ``count`` back, ``kind='kill'`` is a hard kill: the train replay treats
    it as a shrink that also counts toward the kill tally; the serve replay
    fails the victim's in-flight requests over."""

    at_iter: int
    kind: str  # 'shrink' | 'grow' | 'kill'
    count: int = 1

    def __post_init__(self) -> None:
        if self.kind not in ("shrink", "grow", "kill"):
            raise ValueError(f"unknown cluster event kind {self.kind!r}")
        if self.at_iter < 0 or self.count < 1:
            raise ValueError(f"bad cluster event {self}")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Frozen description of one hypothetical fleet.

    Attributes:
      n_hosts:          data-parallel hosts at iteration 0 (1..MAX_HOSTS).
      ici_size:         hosts per fast-tier domain; hosts past one domain
                        talk over the ``'pod'`` axis.  0 (or
                        ``>= n_hosts``) is one flat fast tier, the paper's
                        single-switch 10GbE rack.
      fabric:           the fabric-registry preset that prices collectives.
      straggler_spread: per-host compute multipliers are drawn uniformly
                        from ``[1, 1 + spread]``; 0.0 is homogeneous.
      seed:             seeds the straggler draw (and nothing else).
      events:           scripted elastic transitions (``ClusterEvent``).
      name:             a label for reports (defaults to the geometry).
    """

    n_hosts: int
    ici_size: int = 0  # 0 = flat: one fast-tier domain spanning the fleet
    fabric: str = "tpu_v5e"
    straggler_spread: float = 0.0
    seed: int = 0
    events: tuple[ClusterEvent, ...] = ()
    name: str = ""

    def __post_init__(self) -> None:
        if not (1 <= self.n_hosts <= MAX_HOSTS):
            raise ValueError(
                f"n_hosts must be in 1..{MAX_HOSTS}, got {self.n_hosts}"
            )
        if self.ici_size < 0:
            raise ValueError(f"ici_size must be >= 0, got {self.ici_size}")
        if self.straggler_spread < 0:
            raise ValueError(
                f"straggler_spread must be >= 0, got {self.straggler_spread}"
            )
        if not self.name:
            object.__setattr__(
                self,
                "name",
                f"{self.fabric}x{self.n_hosts}"
                + (f"i{self.ici_size}" if self.ici_size else ""),
            )
        object.__setattr__(self, "events", tuple(self.events))

    # -- geometry -----------------------------------------------------------

    def axis_sizes(self, n_alive: int | None = None) -> dict[str, int]:
        """Two-tier mesh axes for ``n_alive`` hosts: ``min(n, ici_size)``
        hosts on ``'data'``, the rest stacked on ``'pod'``, the shape every
        ``Fabric.cost`` composes hierarchically."""
        n = self.n_hosts if n_alive is None else int(n_alive)
        if n < 1:
            raise ValueError(f"n_alive must be >= 1, got {n}")
        ici = self.ici_size if self.ici_size else n
        fast = min(n, ici)
        pods = math.ceil(n / fast)
        return {"data": fast, "pod": pods} if pods > 1 else {"data": fast}

    def ar_model(self, n_alive: int | None = None):
        """The fleet's all-reduce ``AllReduceModel`` at ``n_alive`` hosts:
        the registered fabric priced at this spec's two-tier geometry."""
        from ..fabric import Collective, get_fabric

        return get_fabric(self.fabric).cost(
            Collective.ALL_REDUCE, self.axis_sizes(n_alive)
        )

    def straggler_multipliers(self, n_alive: int | None = None) -> tuple[float, ...]:
        """Per-host compute multipliers (>= 1), seeded: one draw for all
        ``n_hosts`` slots, so host ``i`` keeps its multiplier across shrink
        and grow."""
        n = self.n_hosts if n_alive is None else int(n_alive)
        if self.straggler_spread == 0.0:
            return (1.0,) * n
        rng = np.random.default_rng(self.seed)
        draw = 1.0 + self.straggler_spread * rng.random(max(n, self.n_hosts))
        return tuple(float(m) for m in draw[:n])

    def alive_after(self, iteration: int) -> tuple[int, int]:
        """(n_alive, n_kills) once every event with ``at_iter <=
        iteration`` is applied, clamped to ``1..MAX_HOSTS``."""
        n, kills = self.n_hosts, 0
        for ev in self.events:
            if ev.at_iter > iteration:
                continue
            if ev.kind == "grow":
                n += ev.count
            else:
                n -= ev.count
                if ev.kind == "kill":
                    kills += ev.count
        return max(1, min(n, MAX_HOSTS)), kills

    # -- serialization (as planning.Plan's) ---------------------------------

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "format": CLUSTER_SPEC_FORMAT,
            "n_hosts": self.n_hosts,
            "ici_size": self.ici_size,
            "fabric": self.fabric,
            "straggler_spread": self.straggler_spread,
            "seed": self.seed,
            "events": [dataclasses.asdict(e) for e in self.events],
            "name": self.name,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), indent=1, sort_keys=True)

    @classmethod
    def from_json_dict(cls, d: dict[str, Any]) -> "ClusterSpec":
        if d.get("format") != CLUSTER_SPEC_FORMAT:
            raise ValueError(f"unsupported cluster spec format {d.get('format')!r}")
        return cls(
            n_hosts=int(d["n_hosts"]),
            ici_size=int(d["ici_size"]),
            fabric=d["fabric"],
            straggler_spread=float(d["straggler_spread"]),
            seed=int(d["seed"]),
            events=tuple(ClusterEvent(**e) for e in d["events"]),
            name=d.get("name", ""),
        )

    @classmethod
    def from_json(cls, text: str) -> "ClusterSpec":
        return cls.from_json_dict(json.loads(text))
