"""Serving (counterpart of ``repro/serving``): continuous batching over one
captured decode step (``engine``).

Ported: ``Request``, ``ServingEngine``, ``ServeTimer`` and the samplers.
Still to port, each raising or absent until then: sharded TP decode
(``sharded``, ROADMAP A.3.1), snapshots, chaos and the resilient serve loop
(``resilience``, A.3.2), and the fleet (``fleet``, A.3.3)."""

from .engine import Request, ServeTimer, ServingEngine, greedy, gumbel_sampler

__all__ = [
    "Request",
    "ServeTimer",
    "ServingEngine",
    "greedy",
    "gumbel_sampler",
]
