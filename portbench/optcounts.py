"""The optimizer's work, counted from the configuration (not from the
program), so that it reads the same whatever implements the update."""

from __future__ import annotations

from . import weights


def param_totals(cfg: dict) -> tuple[int, int]:
    """(bytes as stored, elements) of every parameter the configuration
    states."""
    nbytes = elems = 0
    for g in weights.groups(cfg):
        n = len(g.leaves)
        for s in g.shape:
            n *= s
        elems += n
        nbytes += n * g.dtype.itemsize
    return nbytes, elems


def adamw_bytes(param_bytes: int, param_elems: int) -> int:
    """Bytes one AdamW step must move: the parameters read and written
    once and the gradients read once, as stored, and the f32 first and
    second moments each read and written once."""
    return 3 * param_bytes + 4 * 4 * param_elems
