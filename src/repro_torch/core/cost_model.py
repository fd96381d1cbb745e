"""Backward/forward per-layer compute-time model (paper Eq. 18, Paleo-style).

The paper models the backward time of layer ``l`` as a function of its
parameter count, the device throughput ``G`` and "other factors" θ::

    t_b^(l) = T_b(p^(l), G, θ)                                    (Eq. 18)

We make this concrete with a per-layer *roofline* estimate:

    t = max(flops / (peak_flops * mxu_eff),  bytes / (hbm_bw * hbm_eff))

FLOPs and bytes per layer come from one of two sources:

  * analytic:   flops = ``flops_per_param_token * p * tokens_local``
                (6 for fwd+bwd, 4 for bwd only, 2 for fwd; +attention terms
                supplied by the caller when relevant);
  * measured:   exact per-layer numbers from a profiled segment (the
                paper benchmarking the first few iterations; the port's
                profiler is still to come).

Hardware presets carry the constants given in the project brief
(TPU v5e: 197 TFLOP/s bf16, 819 GB/s HBM) and a K80 preset used to
reproduce the paper's own experiments.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-chip hardware constants for roofline-style time estimates."""

    name: str
    peak_flops: float  # FLOP/s at the training dtype
    hbm_bw: float  # B/s
    mxu_eff: float = 0.6  # achievable fraction of peak on dense matmul
    hbm_eff: float = 0.8  # achievable fraction of peak DRAM bandwidth

    def compute_time(self, flops: float, bytes_accessed: float = 0.0) -> float:
        """Roofline time for one op/layer on one chip."""
        t_flops = flops / (self.peak_flops * self.mxu_eff)
        t_bytes = bytes_accessed / (self.hbm_bw * self.hbm_eff) if bytes_accessed else 0.0
        return max(t_flops, t_bytes)


#: TPU v5e, bf16 — constants from the project brief.
TPU_V5E = Hardware(name="tpu_v5e", peak_flops=197e12, hbm_bw=819e9)

#: Nvidia K80 (one GK210 die), fp32 — the paper's GPU.  ~4.37 TFLOP/s fp32
#: boost, 240 GB/s.  mxu_eff=0.33 is a typical K80-era cuDNN CNN efficiency.
NVIDIA_K80 = Hardware(
    name="nvidia_k80", peak_flops=4.37e12, hbm_bw=240e9, mxu_eff=0.33, hbm_eff=0.6
)

#: Calibrated variant used to reproduce the paper's cluster: the paper runs
#: two GK210 dies per node (halving per-die batch) and reports faster
#: per-layer backward times than the analytic conv-flops model; fitting the
#: single free throughput parameter against the paper's measured 8-node
#: MG-WFBP gains (1.2x vs WFBP, 1.36x vs SyncEASGD) gives mxu_eff ~= 1.0 of
#: one die's nominal peak.  All paper-reproduction tables use this preset;
#: the calibration is recorded in EXPERIMENTS.md.
K80_CALIBRATED = Hardware(
    name="nvidia_k80_calibrated", peak_flops=4.37e12, hbm_bw=240e9, mxu_eff=1.0, hbm_eff=0.6
)


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Static per-layer record fed to the scheduler.

    Attributes:
      name:        human-readable layer name (diagnostics only).
      params:      number of learnable scalars in the layer ``p^(l)``.
      grad_bytes:  size of the gradient *message* this layer contributes to
                   the data-parallel all-reduce.  Usually
                   ``params * comm_dtype_bytes / model_shards`` — model-axis
                   sharding (FSDP/TP/EP) divides the DP message.
      bwd_flops:   backward FLOPs for this layer (per chip).
      bwd_bytes:   HBM bytes touched in backward (per chip); 0 = flops-bound.
      fwd_flops:   forward FLOPs (per chip), used for t_f.
      fwd_bytes:   HBM bytes touched in forward (per chip).
    """

    name: str
    params: int
    grad_bytes: int
    bwd_flops: float
    bwd_bytes: float = 0.0
    fwd_flops: float = 0.0
    fwd_bytes: float = 0.0

    def t_b(self, hw: Hardware) -> float:
        return hw.compute_time(self.bwd_flops, self.bwd_bytes)

    def t_f(self, hw: Hardware) -> float:
        return hw.compute_time(self.fwd_flops, self.fwd_bytes)


def lm_layer_costs(
    layer_params: list[tuple[str, int]],
    tokens_per_chip: int,
    hw: Hardware = TPU_V5E,
    comm_dtype_bytes: int = 4,
    model_shards: int = 1,
    bwd_flops_per_param_token: float = 4.0,
    fwd_flops_per_param_token: float = 2.0,
    extra_bwd_flops: dict[str, float] | None = None,
    extra_fwd_flops: dict[str, float] | None = None,
    activation_bytes: dict[str, float] | None = None,
) -> list[LayerCost]:
    """Analytic LayerCost list for a parameterized model.

    ``layer_params`` is ordered layer 1..L (forward order), exactly the
    paper's ``p = [p^(1), ..., p^(L)]``.  ``extra_*_flops`` lets callers add
    non-parametric compute (attention score matmuls) per layer name.
    """
    extra_b = extra_bwd_flops or {}
    extra_f = extra_fwd_flops or {}
    act_bytes = activation_bytes or {}
    out = []
    for name, p in layer_params:
        bwd = bwd_flops_per_param_token * p * tokens_per_chip + extra_b.get(name, 0.0)
        fwd = fwd_flops_per_param_token * p * tokens_per_chip + extra_f.get(name, 0.0)
        out.append(
            LayerCost(
                name=name,
                params=p,
                grad_bytes=max(1, p * comm_dtype_bytes // model_shards),
                bwd_flops=bwd,
                bwd_bytes=act_bytes.get(name, 0.0),
                fwd_flops=fwd,
                fwd_bytes=act_bytes.get(name, 0.0),
            )
        )
    return out
