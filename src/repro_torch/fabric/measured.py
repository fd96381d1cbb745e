"""The ``measured`` fabric: live timed-collective fits behind the same
registry surface as the analytic presets (counterpart of
``repro/fabric/measured.py``).

``MeasuredFabric`` wraps per-axis all-reduce fits — typically
``planning.MeasuredComm.time_psums(...).fit()`` per axis (journal
§V-A Fig. 5(b), online) — and serves them through ``cost(op,
axis_sizes)``.  Ops other than all-reduce are derived from the measured
all-reduce by the ring decomposition (all-reduce = reduce-scatter ∘
all-gather, each one phase: half the startup, half the slope) — honest
for ring backends, and exactly the approximation the analytic algebra
makes in reverse.  A direct fit for a specific op can be stored under
``'<op>@<axes>'`` to override the derivation.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..core.comm_model import AllReduceModel
from .model import Collective


def _axes_key(axis_sizes: dict[str, int]) -> str:
    """Canonical lookup key: '+'-joined axis names, sorted.

    Axis *names* (not sizes) select the fit — a sweep timed over the
    ``data`` axis is the ``data`` model whatever the virtual world size,
    because the fit already bakes in the real topology it ran on.
    """
    axes = sorted(axis_sizes)
    return "+".join(axes) if axes else "*"


@dataclasses.dataclass(frozen=True)
class MeasuredFabric:
    """Fitted (α, β) constants served through the ``Fabric`` protocol.

    ``models`` maps an axes key (``'data'``, ``'data+pod'``, or ``'*'``
    as a catch-all) to that axis set's measured *all-reduce* fit; op-
    specific overrides use ``'all_gather@data'``-style keys.
    """

    models: dict[str, AllReduceModel]
    name: str = "measured"

    @classmethod
    def from_comm(cls, *comms: Any, name: str = "measured") -> "MeasuredFabric":
        """Build from ``MeasuredComm``-like records (anything with
        ``.axes`` and ``.fit() -> AllReduceModel``)."""
        models = {"+".join(sorted(c.axes)): c.fit() for c in comms}
        return cls(models=models, name=name)

    def with_fits(self, fits: dict[str, AllReduceModel]) -> "MeasuredFabric":
        """New fabric with ``fits`` merged in — op-specific keys
        (``'all_gather@model'``, e.g. from a
        timed serving sweep) override the ring derivation for
        that op; axes keys replace the base all-reduce fit."""
        return dataclasses.replace(self, models={**self.models, **fits})

    def cost(self, op: Collective | str, axis_sizes: dict[str, int]) -> AllReduceModel:
        op = Collective(op)
        key = _axes_key(axis_sizes)
        fit = self.models.get(f"{op.value}@{key}")
        if fit is not None:
            return dataclasses.replace(fit, name=f"{self.name}:{op.value}")
        fit = self.models.get(key, self.models.get("*"))
        if fit is None:
            known = ", ".join(sorted(self.models))
            raise KeyError(f"no measured fit for axes {key!r}; have: {known}")
        if op is not Collective.ALL_REDUCE:
            # one ring phase of the measured two-phase all-reduce
            fit = AllReduceModel(a=fit.a / 2, b=fit.b / 2, name=fit.name)
        return AllReduceModel(a=fit.a, b=fit.b, name=f"{self.name}:{op.value}")
