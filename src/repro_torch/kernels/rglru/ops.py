"""Public ops for the RG-LRU recurrence: the CUDA kernels of
``csrc/rglru.cu`` for tensors on the card, the plain versions of ``ref.py``
for tensors on the CPU (counterpart of ``repro/kernels/rglru/ops.py``).

Which path runs follows from where the tensors lie, and from nothing
else: a CUDA tensor launches the kernel or raises.  Each kernel's wrapper
(``rglru_fwd``, ``rglru_bwd``) counts its launches in ``.launches`` and its
calls that took the plain version in ``.ref_calls``; ``reset_counts()``
zeroes them.

``rglru`` is the differentiable op (``RGLRUScan``): its forward launches
``rglru_fwd`` and saves ``(a, h, h0)``, its backward launches
``rglru_bwd``.  The kernels take float32 tensors only and raise on
anything else.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build
from .ref import rglru_bwd_ref, rglru_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "rglru.cu"

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_fwd.argtypes = [p] * 5 + [i, i, i, p]
        lib.rglru_bwd.argtypes = [p] * 8 + [i, i, i, p]
        lib.rglru_fwd.restype = lib.rglru_bwd.restype = ctypes.c_int
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
    raise ValueError(f"the RG-LRU ops run on cuda or cpu tensors of one device, got "
                     f"{sorted(str(t.device) for t in given)}")


def _check_shapes(seq: dict[str, torch.Tensor], rows: dict[str, torch.Tensor | None]):
    """Every ``seq`` tensor (B, T, W), every ``rows`` tensor (B, W) or None;
    returns (B, T, W)."""
    shape = next(iter(seq.values())).shape
    if len(shape) != 3:
        raise ValueError(f"expected (B, T, W) tensors, got {tuple(shape)}")
    for name, t in seq.items():
        if t.shape != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {tuple(shape)}")
    for name, t in rows.items():
        if t is not None and t.shape != (shape[0], shape[2]):
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {(shape[0], shape[2])}")
    return shape


def _f32(name: str, t: torch.Tensor | None) -> torch.Tensor | None:
    if t is None:
        return None
    if t.dtype != torch.float32:
        raise TypeError(f"the RG-LRU kernels take float32 tensors, got {name} {t.dtype}")
    return t.contiguous()


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check_launch(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"RG-LRU {what} launch failed: cudaError {err}")


def rglru_fwd(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor | None = None):
    """The recurrence ``h_t = a_t h_{t-1} + g_t`` (B6): h (B, T, W) and
    hT (B, W), f32."""
    B, T, W = _check_shapes({"a": a, "g": g}, {"h0": h0})
    if _on_cpu(a, g, h0):
        rglru_fwd.ref_calls += 1
        return rglru_ref(a, g, h0)
    a, g, h0 = _f32("a", a), _f32("g", g), _f32("h0", h0)
    h = torch.empty_like(a)
    hT = torch.empty(B, W, dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _check_launch(_library().rglru_fwd(a.data_ptr(), g.data_ptr(), _ptr(h0), h.data_ptr(),
                                       hT.data_ptr(), B, T, W, stream), "forward")
    rglru_fwd.launches += 1
    return h, hT


def rglru_bwd(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor | None, dh: torch.Tensor,
              dhT: torch.Tensor | None = None):
    """Gradient of ``rglru_fwd`` from its output ``h``: (da, dg, dh0), f32;
    dh0 is None when ``h0`` is None, and ``dhT`` None means zero."""
    B, T, W = _check_shapes({"a": a, "h": h, "dh": dh}, {"h0": h0, "dhT": dhT})
    if _on_cpu(a, h, h0, dh, dhT):
        rglru_bwd.ref_calls += 1
        return rglru_bwd_ref(a, h, h0, dh, dhT)
    a, h, h0, dh, dhT = (_f32(n, t) for n, t in
                         (("a", a), ("h", h), ("h0", h0), ("dh", dh), ("dhT", dhT)))
    da, dg = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _check_launch(_library().rglru_bwd(a.data_ptr(), h.data_ptr(), _ptr(h0), dh.data_ptr(),
                                       _ptr(dhT), da.data_ptr(), dg.data_ptr(), _ptr(dh0),
                                       B, T, W, stream), "backward")
    rglru_bwd.launches += 1
    return da, dg, dh0


class RGLRUScan(torch.autograd.Function):
    """The differentiable recurrence; saves ``(a, h, h0)``."""

    @staticmethod
    def forward(ctx, a, g, h0):
        h, hT = rglru_fwd(a, g, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.set_materialize_grads(False)  # an unused hT passes no zeros
        return h, hT

    @staticmethod
    def backward(ctx, dh, dhT):
        a, h, h0 = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        # autograd may hand the cotangent over strided
        da, dg, dh0 = rglru_bwd(a, h, h0, dh.contiguous(), dhT)
        return da, dg, dh0


def rglru(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor | None = None):
    """``h_t = a_t h_{t-1} + g_t`` with gradients through the kernels:
    h (B, T, W) and hT (B, W)."""
    return RGLRUScan.apply(a, g, h0)


def reset_counts() -> None:
    """Zero the launch and plain-call counters of the two kernel wrappers."""
    for fn in (rglru_fwd, rglru_bwd):
        fn.launches = 0
        fn.ref_calls = 0


reset_counts()
