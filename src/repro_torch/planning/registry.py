"""Scheduler-policy registry.

Every way of turning a per-layer cost vector into a gradient-merge
``Schedule`` — the paper's Algorithm 1, its baselines, the beyond-paper
exact DP, and whatever future PRs add — registers here under a name.
This replaces the two parallel string dispatches the repo used to have
(``core.trainer.build_schedule``'s if-chain and ``SyncConfig.strategy``):
a policy name is now the *single* selection mechanism end to end, and the
sync engine derives its structure from the schedule alone.

A policy is a callable::

    policy(costs: list[LayerCost], ar_model: AllReduceModel,
           hw: Hardware = TPU_V5E, t_f: float | None = None,
           **opts) -> Schedule

The registry guarantees the returned schedule carries an evaluated
``TimelineResult`` (re-evaluating when the policy did not).

Aliases map the historical ``SyncConfig.strategy`` vocabulary onto
policies: ``per_tensor`` -> ``wfbp``, ``single`` -> ``synceasgd``,
``bucketed`` -> ``mg_wfbp``.
"""

from __future__ import annotations

from typing import Callable, Protocol

from ..core.comm_model import AllReduceModel
from ..core.cost_model import Hardware, LayerCost, TPU_V5E
from ..core.schedule import (
    Schedule,
    dp_optimal_schedule,
    evaluate_schedule,
    fixed_bucket_schedule,
    mg_wfbp_schedule,
    optimal_schedule,
    synceasgd_schedule,
    wfbp_schedule,
)


class PolicyFn(Protocol):
    def __call__(
        self,
        costs: list[LayerCost],
        ar_model: AllReduceModel,
        hw: Hardware = ...,
        t_f: float | None = ...,
        **opts,
    ) -> Schedule: ...


_POLICIES: dict[str, PolicyFn] = {}
_ALIASES: dict[str, str] = {
    # historical SyncConfig.strategy names
    "per_tensor": "wfbp",
    "single": "synceasgd",
    "bucketed": "mg_wfbp",
}


def register_policy(
    name: str, *, aliases: tuple[str, ...] = (), overwrite: bool = False
) -> Callable[[PolicyFn], PolicyFn]:
    """Decorator registering ``fn`` as scheduler policy ``name``."""

    def deco(fn: PolicyFn) -> PolicyFn:
        if not overwrite:
            for key in (name, *aliases):
                if key in _POLICIES or key in _ALIASES:
                    raise ValueError(f"policy name {key!r} already registered")
        _POLICIES[name] = fn
        for a in aliases:
            _ALIASES[a] = name
        return fn

    return deco


def resolve_policy_name(name: str) -> str:
    """Canonical policy name (aliases resolved); raises on unknown."""
    name = _ALIASES.get(name, name)
    if name not in _POLICIES:
        known = ", ".join(sorted(set(_POLICIES) | set(_ALIASES)))
        raise KeyError(f"unknown scheduler policy {name!r}; known: {known}")
    return name


def get_policy(name: str) -> PolicyFn:
    """Look up a registered scheduler policy by (aliased) name.

    Example: ``get_policy("mg_wfbp")(costs, ar_model, hw=TPU_V5E)``."""
    return _POLICIES[resolve_policy_name(name)]


def available_policies() -> tuple[str, ...]:
    """Canonical policy names, sorted."""
    return tuple(sorted(_POLICIES))


def build_schedule(
    policy: str,
    costs: list[LayerCost],
    ar_model: AllReduceModel,
    hw: Hardware = TPU_V5E,
    t_f: float | None = None,
    **opts,
) -> Schedule:
    """Run a registered policy and guarantee an evaluated result.

    ``opts`` are forwarded to the policy; every built-in accepts
    ``mode='overlap'|'serialized'`` (``core.timeline.MODES``) selecting the
    issue-order model the schedule is optimized and priced under.
    """
    schedule = get_policy(policy)(costs, ar_model, hw=hw, t_f=t_f, **opts)
    if schedule.result is None:
        schedule = evaluate_schedule(
            schedule, costs, ar_model, hw, t_f, mode=opts.get("mode", "overlap")
        )
    return schedule


# ---------------------------------------------------------------------------
# Built-in policies (paper Algorithm 1 + baselines + beyond-paper exact DP)
# ---------------------------------------------------------------------------


@register_policy("wfbp", aliases=())
def _wfbp(costs, ar_model, hw=TPU_V5E, t_f=None, *, mode: str = "overlap", **opts) -> Schedule:
    """WFBP [10,12]: one all-reduce per layer (𝕄 = ∅)."""
    return evaluate_schedule(wfbp_schedule(len(costs)), costs, ar_model, hw, t_f, mode=mode)


@register_policy("synceasgd")
def _synceasgd(costs, ar_model, hw=TPU_V5E, t_f=None, *, mode: str = "overlap", **opts) -> Schedule:
    """SyncEASGD [15]: single merged message after backward."""
    return evaluate_schedule(
        synceasgd_schedule(len(costs)), costs, ar_model, hw, t_f, mode=mode
    )


@register_policy("fixed")
def _fixed(costs, ar_model, hw=TPU_V5E, t_f=None, *, bucket_bytes: int = 25 * 2**20, mode: str = "overlap", **opts) -> Schedule:
    """DDP/Horovod-style size-threshold tensor fusion."""
    return evaluate_schedule(
        fixed_bucket_schedule(costs, bucket_bytes), costs, ar_model, hw, t_f, mode=mode
    )


@register_policy("mg_wfbp")
def _mg_wfbp(costs, ar_model, hw=TPU_V5E, t_f=None, *, mode: str = "overlap", **opts) -> Schedule:
    """Paper Algorithm 1 greedy merge (O(L²), run once)."""
    return mg_wfbp_schedule(costs, ar_model, hw, t_f, mode=mode)


@register_policy("dp_optimal")
def _dp_optimal(costs, ar_model, hw=TPU_V5E, t_f=None, *, mode: str = "overlap", **opts) -> Schedule:
    """Beyond-paper exact optimum via the O(L²) Bellman recursion."""
    return dp_optimal_schedule(costs, ar_model, hw, t_f, mode=mode)


@register_policy("optimal")
def _optimal(costs, ar_model, hw=TPU_V5E, t_f=None, *, max_layers: int = 22, mode: str = "overlap", **opts) -> Schedule:
    """Exhaustive 2^(L-1) enumeration — small L only (tests, validation)."""
    return optimal_schedule(costs, ar_model, hw, t_f, max_layers=max_layers, mode=mode)
