"""The comparison that decides ``correct``: numbers read from the program
against the same numbers from the plain reference, each held to its
limit.

Training compares three numbers over the first steps:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the norms of its step-1
  gradient, the program's worked out from AdamW's first moment after one
  step;
* ``change_gap``: the worst leaf's gap between the norms of its change
  over the steps.

A leaf's gap is ``|program norm - reference norm|`` over the larger of the
reference's norm of that leaf and of the median leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of ``change_gap``.
"""

from __future__ import annotations

import statistics
import sys

SMALL_GRAD = 1e-3  # of the median leaf's gradient norm: the leaf moves by round-off


def leaf_gaps(prog: dict[str, float], ref: dict[str, float],
              names: list[str] | None = None) -> dict[str, float]:
    """Each leaf's gap (of ``names``, every leaf when None)."""
    names = sorted(ref) if names is None else names
    if sorted(prog) != sorted(ref):
        raise ValueError("the program and the reference read different leaves")
    med = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        base = max(ref[n], med)
        out[n] = abs(prog[n] - ref[n]) / base if base > 0 else abs(prog[n] - ref[n])
    return out


def worst(gaps: dict[str, float]) -> dict:
    at = max(gaps, key=gaps.get)
    return {"value": gaps[at], "at": at}


def train_numbers(prog: dict, ref: dict) -> dict[str, dict]:
    """``{number: {"value", "at"}}`` for the training comparison."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    med = statistics.median(ref["grad_norms"].values())
    moved = [n for n, g in ref["grad_norms"].items() if g >= SMALL_GRAD * med]
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": {"value": max(losses), "at": f"step {losses.index(max(losses)) + 1}"},
            "grad_gap": worst(grad),
            "change_gap": {**worst(change), "left_out": len(ref["grad_norms"]) - len(moved)}}


def verdict(numbers: dict[str, dict], limits: dict[str, float]) -> tuple[bool, dict]:
    """``(correct, checks)``: each number beside its limit; a number that is
    not finite fails."""
    checks, ok = {}, True
    for name, lim in limits.items():
        v = numbers[name]["value"]
        good = v == v and v <= lim  # NaN fails
        ok &= good
        checks[name] = {"value": v, "limit": lim}
    return ok, checks


def print_checks(checks: dict, correct: bool) -> None:
    """The compared numbers as the last lines on standard error."""
    for name, c in checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"[check] correct {correct}", file=sys.stderr, flush=True)
