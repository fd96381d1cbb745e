"""Planning: scheduler-policy registry, the frozen ``Plan`` artifact and
cost sources."""

from .costs import AnalyticCosts, CostSource
from .plan import PLAN_FORMAT, Plan, build_plan
from .registry import (
    available_policies,
    build_schedule,
    get_policy,
    register_policy,
    resolve_policy_name,
)

__all__ = [
    "AnalyticCosts",
    "CostSource",
    "PLAN_FORMAT",
    "Plan",
    "available_policies",
    "build_plan",
    "build_schedule",
    "get_policy",
    "register_policy",
    "resolve_policy_name",
]
