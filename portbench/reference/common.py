"""Plain PyTorch pieces of the reference, in float32 with TF32 off.

``Matmul`` is the one place where the precision is chosen: ``float32`` is
the reference itself; ``fp8`` is the control, where what the program
computes and keeps in bf16 is held in float8 instead: every product's
operands and the residual stream between sublayers rounded to e4m3 (a
scale per tensor) in the forward and the gradients flowing into them to
e5m2 in the backward, the products accumulated in float32; ``bfloat16``
rounds the same tensors to bfloat16, the program's own precision, to tell
rounding from a fault.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "bfloat16", "fp8")
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def no_tf32() -> None:
    """Every float32 product in full float32 (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_quant(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to ``top``, returned in float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale)


class _Fp8Operand(torch.autograd.Function):
    """e4m3 in the forward; the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x):
        return fake_quant(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8GradIn(torch.autograd.Function):
    """Identity in the forward; the gradient rounded to e5m2 before the
    backward products read it."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return fake_quant(g, torch.float8_e5m2, E5M2_MAX)


class Matmul:
    """``mm(a, b)`` = ``a @ b`` at the chosen precision (``PRECISIONS``);
    ``mm.operand(x)`` rounds a tensor that the program holds in its
    working precision (an operand of the WKV recurrence, the residual
    stream) as ``mm`` rounds its own operands."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "float32":
            return a @ b
        if self.precision == "bfloat16":
            return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()
        return _Fp8GradIn.apply(_Fp8Operand.apply(a) @ _Fp8Operand.apply(b))

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "float32":
            return x
        if self.precision == "bfloat16":
            return x.to(torch.bfloat16).float()
        return _Fp8GradIn.apply(_Fp8Operand.apply(x))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0.. on (B, S, H, hd), the halves rotated as pairs
    (x[i], x[i + hd/2]) at frequency theta^(-2i/hd)."""
    B, S, H, hd = x.shape
    i = torch.arange(hd // 2, dtype=torch.float64, device=x.device)
    freqs = (1.0 / theta ** (2.0 * i / hd)).float()
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood of ``targets`` under float32 logits."""
    return torch.logsumexp(logits, -1) - logits.gather(-1, targets[..., None]).squeeze(-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
