"""α–β communication cost models for all-reduce (paper §II-D, Table II).

The paper models a single all-reduce of ``M`` bytes across ``N`` workers as

    T_ar(M) = a + b * M                                           (Eq. 9)

where ``a`` (startup, seconds) and ``b`` (seconds/byte) depend on the
all-reduce algorithm and the point-to-point parameters:

    alpha : p2p latency between two nodes (s)
    beta  : p2p transmission time per byte (s/B)
    gamma : reduction (summation) time per byte on one node (s/B)

Table II of the paper gives (a, b) for four classic algorithms; all are
implemented below.  The key property exploited by MG-WFBP is Eq. 10:

    T_ar(M1) + T_ar(M2) > T_ar(M1 + M2)        (because a > 0)

so merging messages strictly reduces pure communication time.

Backend presets
---------------
On a TPU v5e pod the DP all-reduce runs over ICI (2-D torus) instead of
10GbE MPI; on a GPU cluster over NVLink + IB.  The form of the model is
unchanged; only the constants move.  Backend presets live in the fabric
registry (``repro_torch.fabric``): ``get_fabric("tpu_v5e")`` etc. serve per-op
affine models (all-reduce, reduce-scatter, all-gather, all-to-all) from
the same (α, β, γ) primitives.  The historical TPU names —
``TpuInterconnect``, ``TPU_V5E``, ``tpu_psum_model`` — remain importable
from this module as re-exports of the ``tpu_v5e`` preset (lazy, to keep
the primitive layer free of the fabric package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Classic MPI-style models (paper Table II)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AllReduceModel:
    """Affine all-reduce cost model ``T_ar(M) = a + b*M`` (Eq. 9)."""

    a: float  # startup, seconds
    b: float  # seconds per byte
    name: str = "affine"

    def __call__(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return self.a + self.b * float(nbytes)

    def merged_gain(self, m1: float, m2: float) -> float:
        """T(m1) + T(m2) - T(m1+m2) = a  (Eq. 10); >0 whenever a > 0."""
        return self(m1) + self(m2) - self(m1 + m2)


def binary_tree(n: int, alpha: float, beta: float, gamma: float) -> AllReduceModel:
    """Binary-tree all-reduce (Table II row 1)."""
    lg = math.log2(n)
    return AllReduceModel(a=2 * alpha * lg, b=(2 * beta + gamma) * lg, name="binary_tree")


def recursive_doubling(n: int, alpha: float, beta: float, gamma: float) -> AllReduceModel:
    """Recursive-doubling all-reduce (Table II row 2)."""
    lg = math.log2(n)
    return AllReduceModel(a=alpha * lg, b=(beta + gamma) * lg, name="recursive_doubling")


def recursive_halving_doubling(
    n: int, alpha: float, beta: float, gamma: float
) -> AllReduceModel:
    """Recursive halving-and-doubling (Rabenseifner; Table II row 3)."""
    lg = math.log2(n)
    return AllReduceModel(
        a=2 * alpha * lg,
        b=2 * beta - (2 * beta + gamma) / n + gamma,
        name="recursive_halving_doubling",
    )


def ring(n: int, alpha: float, beta: float, gamma: float) -> AllReduceModel:
    """Ring all-reduce (Table II row 4) — the NCCL/ICI workhorse."""
    return AllReduceModel(
        a=2 * (n - 1) * alpha,
        b=2 * (n - 1) / n * beta + (n - 1) / n * gamma,
        name="ring",
    )


ALGORITHMS: dict[str, Callable[[int, float, float, float], AllReduceModel]] = {
    "binary_tree": binary_tree,
    "recursive_doubling": recursive_doubling,
    "recursive_halving_doubling": recursive_halving_doubling,
    "ring": ring,
}


def fit_affine(
    nbytes: Sequence[float], seconds: Sequence[float], name: str = "measured"
) -> AllReduceModel:
    """Least-squares (a, b) from measured (M, T_ar(M)) pairs.

    This is the fit of the journal version's Fig. 5(b): time real
    all-reduces over a size sweep, regress T = a + b·M.  Negative
    intercepts/slopes (possible on noisy tiny sweeps where the size range
    does not resolve the startup term) are clamped to zero — the
    schedule math requires a, b ≥ 0 (Eq. 10's merge gain IS ``a``).
    """
    x = np.asarray(nbytes, dtype=float)
    y = np.asarray(seconds, dtype=float)
    if x.shape != y.shape or x.size < 2:
        raise ValueError(f"need ≥2 (size, time) pairs, got {x.size}")
    coeffs, *_ = np.linalg.lstsq(np.stack([np.ones_like(x), x], axis=1), y, rcond=None)
    a, b = float(coeffs[0]), float(coeffs[1])
    return AllReduceModel(a=max(a, 0.0), b=max(b, 0.0), name=name)


# ---------------------------------------------------------------------------
# Paper's measured environment: 8-node K80 cluster, 10GbE + OpenMPI
# ---------------------------------------------------------------------------

#: Paper §V-A: measured ring-all-reduce startup 2(N-1)·alpha was
#: 90.52 / 271.56 / 633.64 µs for N = 2 / 4 / 8  =>  alpha ≈ 45 µs.
PAPER_10GBE_ALPHA = 45.26e-6
#: 10GbE effective payload bandwidth ≈ 1.07 GB/s (paper: 200KB x8 in ~1.5ms
#: includes startup; slope fit from Fig. 5(b) gives roughly 1/1.07e9 s/B).
PAPER_10GBE_BETA = 1.0 / 1.07e9
#: Summation of two fp32 numbers: K80-era CPU/GPU reduce ≈ 30 GB/s.
PAPER_GAMMA = 1.0 / 30e9


def paper_cluster_model(n: int, algorithm: str = "ring") -> AllReduceModel:
    """(a, b) for the paper's 10GbE cluster at ``n`` nodes."""
    return ALGORITHMS[algorithm](n, PAPER_10GBE_ALPHA, PAPER_10GBE_BETA, PAPER_GAMMA)


# ---------------------------------------------------------------------------
# TPU v5e interconnect model — absorbed by the fabric registry
# ---------------------------------------------------------------------------

#: Names now owned by ``repro_torch.fabric`` (the ``tpu_v5e`` preset), re-exported
#: here for back compatibility.  Lazy (PEP 562) because the fabric package
#: imports this module's primitives — an eager import would be circular.
_FABRIC_SHIMS = ("TpuInterconnect", "TPU_V5E", "tpu_psum_model")


def __getattr__(name: str):
    if name in _FABRIC_SHIMS:
        from ..fabric import presets as _presets

        value = getattr(_presets, name)
        globals()[name] = value  # cache: subsequent lookups skip __getattr__
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_FABRIC_SHIMS))
