"""Work and bytes of the measured program, counted from shapes.

The peaks are NVIDIA's data sheet for one H100 SXM (dense rates, 700 W).
Every count reads each input byte once and writes each output byte once,
whatever a kernel reads again, and counts 2 operations a multiply-add.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_FLOPS["3xtf32"] = PEAK_FLOPS["tf32"] / 3  # three TF32 passes a product (B7)

RWKV_LORA_MIX = 32  # the 5-way interpolation lora's rank (arXiv:2404.05892)
RWKV_LORA_DECAY = 64  # the decay lora's rank


def flash_work(B: int, S: int, Hq: int, Hkv: int, hd: int, itemsize: int,
               window: int | None = None) -> dict[str, tuple[int, int]]:
    """(bytes, operations) of each flash kernel over the (query, key) pairs
    that the causal mask and the window leave: ``fwd`` (q, k, v -> o,
    lse), ``dq`` (q, k, v, dO, lse, delta -> dq) and ``dkv`` (-> dk, dv)."""
    w = S if window is None else min(window, S)
    pairs = B * Hq * (w * (w + 1) // 2 + (S - w) * w)
    qb, kvb, rows = B * S * Hq * hd * itemsize, B * S * Hkv * hd * itemsize, B * S * Hq * 4
    return {
        "fwd": (2 * qb + 2 * kvb + rows, 2 * 2 * hd * pairs),
        "dq": (3 * qb + 2 * kvb + 2 * rows, 3 * 2 * hd * pairs),
        "dkv": (2 * qb + 4 * kvb + 2 * rows, 4 * 2 * hd * pairs),
    }


def wkv_work(B: int, T: int, H: int, K: int) -> dict[str, tuple[int, int]]:
    """(bytes, operations) of the WKV recurrence forward and backward at
    bf16 r / k / v, f32 w, u and state.  Operations per state element a
    step: forward r.S (2) and S w + k v (3); backward the state (3), dS
    (3), dS.k, dS.v, S.do, dS*S (2 each)."""
    elems, states = B * T * H * K, B * T * H * K * K
    return {"fwd": ((3 * 2 + 4 + 4) * elems + 4 * H * K + 4 * B * H * K * K, 5 * states),
            "bwd": ((3 * 2 + 4 + 4 + 4 * 4) * elems + 2 * 4 * H * K, 14 * states)}


def pack_bytes(param_bytes: int, n_elems: int, wire_itemsize: int = 4) -> int:
    """Bytes of one step's packs (B1), equal to its unpacks' (B2): every
    gradient read as stored and every arena element written on the wire,
    or the reverse."""
    return param_bytes + n_elems * wire_itemsize


def decode_bytes(param_bytes: int, cache_bytes: int) -> int:
    """Bytes one decode step must read: the weights as stored (the head,
    and an embedding table only when it is the head) and the whole cache
    arena."""
    return param_bytes + cache_bytes


def matmul_params(cfg: dict) -> int:
    """Weights that a token multiplies in one forward, head included and
    the embedding lookup not: what ``6 N`` counts."""
    d, f, L, V = cfg["d_model"], cfg["d_ff"], cfg["n_layers"], cfg["vocab"]
    if cfg["family"] == "dense":
        qd, kvd = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
        mlp = (3 if cfg["mlp"] in ("swiglu", "geglu") else 2) * d * f
        layer = d * qd + 2 * d * kvd + qd * d + mlp
    elif cfg["family"] == "rwkv6":
        lora = 2 * d * 5 * RWKV_LORA_MIX + 2 * d * RWKV_LORA_DECAY
        layer = 5 * d * d + lora + 2 * d * f + d * d
    else:
        raise ValueError(f"no count for family {cfg['family']!r}")
    return L * layer + d * V


def step_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model operations of one training step: 6 N a token over the
    products, plus the sequence mixer forward and backward (causal
    attention 2 T^2 H hd a layer forward, x3 with the backward; the WKV
    recurrence's 5 + 14 a state element a step).  Recompute under
    activation checkpointing is not counted."""
    tokens = batch * seq
    total = 6 * matmul_params(cfg) * tokens
    if cfg["family"] == "dense":
        total += 3 * cfg["n_layers"] * 2 * batch * seq * seq * cfg["n_heads"] * cfg["head_dim"]
    elif cfg["family"] == "rwkv6":
        K = cfg["head_dim"]
        w = wkv_work(batch, seq, cfg["d_model"] // K, K)
        total += cfg["n_layers"] * (w["fwd"][1] + w["bwd"][1])
    return total


def bound_s(nbytes: float, flops: float, peak: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of the byte and the
    operation bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak])
