"""Cost sources: where the scheduler's per-layer time vector comes from
(``CostSource``/``AnalyticCosts`` of ``repro/planning/costs.py``).

The measured sources (segment probes, timed collectives) and online
re-planning are still to port.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

from ..core.cost_model import Hardware, LayerCost, TPU_V5E


@runtime_checkable
class CostSource(Protocol):
    """A producer of the scheduler's per-layer cost vector."""

    name: str
    hw: Hardware

    def layer_costs(self) -> list[LayerCost]: ...


@dataclasses.dataclass(frozen=True)
class AnalyticCosts:
    """Eq. 18-style analytic cost vector."""

    costs: tuple[LayerCost, ...]
    hw: Hardware = TPU_V5E
    name: str = "analytic"

    def layer_costs(self) -> list[LayerCost]:
        return list(self.costs)
