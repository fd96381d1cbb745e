"""The frozen ``SimReport``: what-if curves to plan from (counterpart of
``repro/sim/report.py``).

A ``SimReport`` is the simulator's counterpart of ``Plan`` /
``ServePlan``: a JSON record of every simulated (policy x fleet x fabric)
cell (scaling efficiency and iteration time) and the calibration that
anchors them.  ``best_policy`` reads it as a plan-selection input: the
argmin-``t_iter`` policy for the fleet to run, as ``Tuner.sweep`` picks on
measured costs.

``to_json`` sorts its keys and holds no timestamp, and every number is a
function of the specs and seeds that made it: the same inputs give the
same bytes, in this package and in the JAX one.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

SIM_REPORT_FORMAT = 1


@dataclasses.dataclass(frozen=True)
class SimRow:
    """One simulated (policy x fleet x fabric) cell.

    ``t_iter_s`` / ``efficiency`` are means over the replayed iterations;
    ``n_groups`` is the last schedule's merge-set size."""

    arch: str
    policy: str
    fabric: str
    n_hosts: int
    n_groups: int
    t_iter_s: float
    t_compute_s: float
    t_comm_exposed_s: float
    efficiency: float

    def to_json_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def row_from_replay(result, arch: str, fabric: str, n_hosts: int) -> SimRow:
    """Condense one ``TrainReplayResult`` into a report row (means over
    its iterations; the last iteration's group count)."""
    last = result.iterations[-1]
    return SimRow(
        arch=arch,
        policy=result.policy,
        fabric=fabric,
        n_hosts=int(n_hosts),
        n_groups=int(last["n_groups"]),
        t_iter_s=result.mean_t_iter,
        t_compute_s=sum(r["t_compute_s"] for r in result.iterations)
        / len(result.iterations),
        t_comm_exposed_s=sum(r["t_comm_exposed_s"] for r in result.iterations)
        / len(result.iterations),
        efficiency=result.mean_efficiency,
    )


@dataclasses.dataclass(frozen=True)
class SimReport:
    """A frozen what-if record: rows, calibration and provenance."""

    rows: tuple[SimRow, ...]
    calibration: dict[str, Any] = dataclasses.field(default_factory=dict)
    provenance: dict[str, str] = dataclasses.field(default_factory=dict)

    def select(
        self,
        *,
        arch: str | None = None,
        fabric: str | None = None,
        n_hosts: int | None = None,
        policy: str | None = None,
    ) -> tuple[SimRow, ...]:
        """The rows matching every given filter (None = any)."""
        return tuple(
            r
            for r in self.rows
            if (arch is None or r.arch == arch)
            and (fabric is None or r.fabric == fabric)
            and (n_hosts is None or r.n_hosts == n_hosts)
            and (policy is None or r.policy == policy)
        )

    def best_policy(
        self,
        *,
        arch: str | None = None,
        fabric: str | None = None,
        n_hosts: int | None = None,
    ) -> str:
        """The argmin-``t_iter_s`` policy over the matching rows (ties
        break by group count, then name, as ``Tuner.sweep``'s)."""
        rows = self.select(arch=arch, fabric=fabric, n_hosts=n_hosts)
        if not rows:
            raise ValueError(
                f"no rows match arch={arch} fabric={fabric} n_hosts={n_hosts}"
            )
        return min(rows, key=lambda r: (r.t_iter_s, r.n_groups, r.policy)).policy

    def efficiency_table(self) -> list[str]:
        """One scaling-efficiency line per (fleet, policy): what
        ``launch/simulate.py`` prints."""
        lines = []
        for r in self.rows:
            lines.append(
                f"{r.arch},{r.fabric},hosts={r.n_hosts},{r.policy},"
                f"groups={r.n_groups},t_iter_ms={r.t_iter_s * 1e3:.3f},"
                f"exposed_ms={r.t_comm_exposed_s * 1e3:.3f},eff={r.efficiency:.4f}"
            )
        return lines

    # -- serialization ------------------------------------------------------

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "format": SIM_REPORT_FORMAT,
            "rows": [r.to_json_dict() for r in self.rows],
            "calibration": dict(self.calibration),
            "provenance": dict(self.provenance),
        }

    def to_json(self) -> str:
        """Canonical serialization (sorted keys, no timestamps): the same
        rows give the same bytes."""
        return json.dumps(self.to_json_dict(), indent=1, sort_keys=True)

    @classmethod
    def from_json_dict(cls, d: dict[str, Any]) -> "SimReport":
        if d.get("format") != SIM_REPORT_FORMAT:
            raise ValueError(f"unsupported sim report format {d.get('format')!r}")
        return cls(
            rows=tuple(SimRow(**r) for r in d["rows"]),
            calibration=dict(d.get("calibration", {})),
            provenance=dict(d.get("provenance", {})),
        )

    @classmethod
    def from_json(cls, text: str) -> "SimReport":
        return cls.from_json_dict(json.loads(text))

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json())
        return p

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "SimReport":
        return cls.from_json(pathlib.Path(path).read_text())
