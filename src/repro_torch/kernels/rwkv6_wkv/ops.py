"""Public ops for the WKV6 recurrence: the CUDA kernels of
``csrc/rwkv6_wkv.cu`` for tensors on the card, the plain versions of
``ref.py`` for tensors on the CPU (counterpart of
``repro/kernels/rwkv6_wkv/ops.py``).

Which path runs follows from where the tensors lie, and from nothing
else: a CUDA tensor launches the kernel or raises.  Each kernel's wrapper
(``wkv_fwd``, ``wkv_bwd``) counts its calls that launched in ``.launches``
(``wkv_bwd`` launches its two kernels in one call, counted once) and its
calls that took the plain version in ``.ref_calls``; ``reset_counts()``
zeroes them.

``wkv`` is the differentiable op (``WKV6Function``): its forward launches
``wkv_fwd`` and saves ``(r, k, v, w, u, s0)``, its backward launches
``wkv_bwd``, which recomputes the states it needs.  The kernels take r, k,
v in float32 or bfloat16 (one dtype for the three), everything else in
float32, and head sizes K of 32 or 64; they raise on anything else.
Gradients come back in f32 from ``wkv_bwd`` and in each input's dtype from
``wkv``.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build
from .ref import wkv_bwd_ref, wkv_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "rwkv6_wkv.cu"
HEAD_SIZES = (32, 64)

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv_fwd.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.wkv_bwd.argtypes = [p] * 16 + [i] * 5 + [p]
        lib.wkv_fwd.restype = lib.wkv_bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _on_cpu(*tensors: torch.Tensor | None) -> bool:
    """True for CPU tensors, False for CUDA ones; raises on a mix or on any
    other device."""
    given = [t for t in tensors if t is not None]
    kinds = {t.device.type for t in given}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in given}) == 1:
        return False
    raise ValueError(f"the WKV6 ops run on cuda or cpu tensors of one device, got "
                     f"{sorted(str(t.device) for t in given)}")


def _check_shapes(seq: dict[str, torch.Tensor], u: torch.Tensor,
                  states: dict[str, torch.Tensor | None]) -> tuple[int, int, int, int]:
    """Every ``seq`` tensor (B, T, H, K), ``u`` (H, K), every ``states``
    tensor (B, H, K, K) or None; returns (B, T, H, K)."""
    shape = next(iter(seq.values())).shape
    if len(shape) != 4:
        raise ValueError(f"expected (B, T, H, K) tensors, got {tuple(shape)}")
    B, T, H, K = shape
    for name, t in seq.items():
        if t.shape != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {tuple(shape)}")
    if u.shape != (H, K):
        raise ValueError(f"u is {tuple(u.shape)}, expected {(H, K)}")
    for name, t in states.items():
        if t is not None and t.shape != (B, H, K, K):
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {(B, H, K, K)}")
    return B, T, H, K


def _kernel_inputs(r, k, v, w, u, K, **f32) -> tuple[list[torch.Tensor | None], int]:
    """Contiguous operands for the kernels, and the bf16 flag of r/k/v;
    raises on what the kernels do not take."""
    if K not in HEAD_SIZES:
        raise ValueError(f"the WKV6 kernels take head sizes {HEAD_SIZES}, got {K}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the WKV6 kernels take r, k, v of one dtype, float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    f32 = dict(w=w, u=u, **f32)
    for name, t in f32.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"the WKV6 kernels take {name} in float32, got {t.dtype}")
    ops = [t if t is None else t.contiguous() for t in (r, k, v, *f32.values())]
    return ops, int(r.dtype == torch.bfloat16)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check_launch(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"WKV6 {what} launch failed: cudaError {err}")


def wkv_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, s0: torch.Tensor | None = None):
    """The WKV6 recurrence (B7): ``out`` (B, T, H, K) f32 and ``s_final``
    (B, H, K, K) f32, from r, k, v, w (B, T, H, K), u (H, K) and the
    initial state ``s0`` (zero when None)."""
    B, T, H, K = _check_shapes({"r": r, "k": k, "v": v, "w": w}, u, {"s0": s0})
    if _on_cpu(r, k, v, w, u, s0):
        wkv_fwd.ref_calls += 1
        return wkv_ref(r, k, v, w, u, s0)
    (r, k, v, w, u, s0), bf16 = _kernel_inputs(r, k, v, w, u, K, s0=s0)
    out = torch.empty(B, T, H, K, dtype=torch.float32, device=r.device)
    s_final = torch.empty(B, H, K, K, dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    _check_launch(_library().wkv_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), _ptr(s0),
        out.data_ptr(), s_final.data_ptr(), B, T, H, K, bf16, stream), "forward")
    wkv_fwd.launches += 1
    return out, s_final


def wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, s0: torch.Tensor | None, dout: torch.Tensor,
            ds_final: torch.Tensor | None = None):
    """Gradient of ``wkv_fwd`` from the cotangents ``dout`` (B, T, H, K) and
    ``ds_final`` (B, H, K, K; None means zero): (dr, dk, dv, dw, du, ds0),
    f32; ds0 is None when ``s0`` is None."""
    B, T, H, K = _check_shapes({"r": r, "k": k, "v": v, "w": w, "dout": dout}, u,
                               {"s0": s0, "ds_final": ds_final})
    if _on_cpu(r, k, v, w, u, s0, dout, ds_final):
        wkv_bwd.ref_calls += 1
        return wkv_bwd_ref(r, k, v, w, u, s0, dout, ds_final)
    (r, k, v, w, u, s0, dout, ds_final), bf16 = _kernel_inputs(
        r, k, v, w, u, K, s0=s0, dout=dout, ds_final=ds_final)
    dev = r.device
    dr, dk, dv, dw, x = (torch.empty(B, T, H, K, dtype=torch.float32, device=dev)
                         for _ in range(5))
    du = torch.empty(H, K, dtype=torch.float32, device=dev)
    ds0 = None if s0 is None else torch.empty(B, H, K, K, dtype=torch.float32, device=dev)
    part = torch.empty(2, B, H, K, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check_launch(_library().wkv_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), _ptr(s0),
        dout.data_ptr(), _ptr(ds_final), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dw.data_ptr(), du.data_ptr(), _ptr(ds0), x.data_ptr(), part.data_ptr(),
        B, T, H, K, bf16, stream), "backward")
    wkv_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


class WKV6Function(torch.autograd.Function):
    """The differentiable WKV6; saves ``(r, k, v, w, u, s0)``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        out, s_final = wkv_fwd(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)  # an unused s_final passes no zeros
        return out, s_final

    @staticmethod
    def backward(ctx, dout, ds_final):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        # autograd may hand the cotangent over strided
        grads = wkv_bwd(r, k, v, w, u, s0, dout.contiguous(), ds_final)
        # each gradient in its input's dtype, as JAX's astype VJP rounds it
        return tuple(None if g is None else g.to(x.dtype)
                     for g, x in zip(grads, (r, k, v, w, u, s0)))


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
        s0: torch.Tensor | None = None):
    """The WKV6 recurrence with gradients through the kernels: ``out``
    (B, T, H, K) f32 and ``s_final`` (B, H, K, K) f32."""
    return WKV6Function.apply(r, k, v, w, u, s0)


def reset_counts() -> None:
    """Zero the launch and plain-call counters of the two kernel wrappers."""
    for fn in (wkv_fwd, wkv_bwd):
        fn.launches = 0
        fn.ref_calls = 0


reset_counts()
