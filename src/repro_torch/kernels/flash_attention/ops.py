"""Public ops for flash attention: the CUDA kernels of ``csrc/`` for
tensors on the card, the plain versions of ``ref.py`` for tensors on the
CPU (counterpart of ``repro/kernels/flash_attention/ops.py``).

Which path runs follows from where the tensors lie, and from nothing
else: a CUDA tensor launches the kernel or raises.  Each kernel's wrapper
(``flash_attention_fwd``, ``flash_attention_dq``, ``flash_attention_dkv``)
counts its launches in ``.launches`` (those with a window also in
``.windowed_launches``) and its calls that took the plain version in
``.ref_calls``; ``reset_counts()`` zeroes them.

``flash_attention_train`` is the differentiable op (the JAX package's
custom-VJP ``flash_attention_train``): its forward saves only
``(q, k, v, o, lse)`` and its backward runs the dQ and dK/dV kernels, so
no (Sq, Sk) tensor is kept for backward.

The CUDA kernels take f32 or bf16 inputs and head dims 32, 64, 128 and
256, and raise on anything else.  Every kernel wrapper picks its kernel by
dtype: f32 q, k, v (and dO) go to ``flash_fwd_kernel``, ``flash_dq_kernel``
and ``flash_dkv_kernel`` of ``csrc/flash_attention.cu`` (f32 products on
the CUDA cores), bf16 ones to ``flash_fwd_sm90_kernel``,
``flash_dq_sm90_kernel`` and ``flash_dkv_sm90_kernel`` of
``csrc/flash_sm90.cu`` (``wgmma`` bf16 products with f32 accumulators; p
and dS rounded to bf16 as operands of the second products).  The dtype
decides, nothing else: a failed build or launch raises.  The bf16 dK/dV
kernel splits the G query heads of a KV head into ``ns`` slices
(``_dkv_slices``) so that the grid fills the card,
writes f32 partials into a scratch buffer, and ``flash_dkv_sum_kernel``
adds them in slice order: both launches make one ``flash_attention_dkv``
call, counted once in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .. import _build
from .ref import (
    attention_delta,
    flash_attention_dkv_ref,
    flash_attention_dq_ref,
    flash_attention_fwd_ref,
)

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SM90_SOURCE = SOURCE.with_name("flash_sm90.cu")
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
TILE = 64  # rows of a q or k tile in the bf16 kernels

_lib: ctypes.CDLL | None = None
_sm90_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [p, p, i, i, f, f, p]  # dims, strides, causal, window, scale, softcap, stream
        lib.flash_fwd.argtypes = [p] * 5 + tail
        lib.flash_dq.argtypes = [p] * 7 + tail
        lib.flash_dkv.argtypes = [p] * 8 + tail
        for fn in (lib.flash_fwd, lib.flash_dq, lib.flash_dkv):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _sm90_library() -> ctypes.CDLL:
    global _sm90_lib
    if _sm90_lib is None:
        lib = _build.load(SM90_SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [p, p, i, i, f, f, p]  # dims, strides, causal, window, scale, softcap, stream
        lib.flash_fwd_sm90.argtypes = [p] * 5 + tail
        lib.flash_dq_sm90.argtypes = [p] * 7 + tail
        lib.flash_dkv_sm90.argtypes = [p] * 10 + [i] + tail  # ..., slices, ...
        for fn in (lib.flash_fwd_sm90, lib.flash_dq_sm90, lib.flash_dkv_sm90):
            fn.restype = ctypes.c_int
        _sm90_lib = lib
    return _sm90_lib


def _check_opts(q, k, v, window, softcap) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA ones; raises on a mix or on any
    other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"flash attention runs on cuda or cpu tensors of one device, got "
                     f"{sorted(str(t.device) for t in tensors)}")


def _cuda_args(*tensors, causal, window, softcap):
    """Checks the kernels' conditions on (q, k, v[, dO]); returns them
    contiguous and the trailing launcher arguments."""
    dt = tensors[0].dtype
    if dt not in DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"the flash-attention kernels take float32 or bfloat16 q, k, v and dO "
                        f"of one dtype, got {[str(t.dtype) for t in tensors]}")
    q, k = tensors[0], tensors[1]
    B, Sq, Hq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernels take head dims {HEAD_DIMS}, got {hd}")
    tensors = [t.contiguous() for t in tensors]
    dims = (ctypes.c_int * 6)(B, Sq, k.shape[1], Hq, k.shape[2], hd)
    strides = (ctypes.c_longlong * 6)(*tensors[0].stride()[:3], *tensors[1].stride()[:3])
    tail = [dims, strides, int(causal), 0 if window is None else int(window),
            float(hd**-0.5), 0.0 if softcap is None else float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream]
    return tensors, tail


def _rows_f32(x: torch.Tensor, q: torch.Tensor, name: str) -> torch.Tensor:
    if x.shape != q.shape[:3] or x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 {tuple(q.shape[:3])}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data is 16-byte aligned (the bf16 kernels load
    16-byte chunks), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dkv_slices(q: torch.Tensor, k: torch.Tensor) -> int:
    """Slices of the G query heads of a KV head for the bf16 dK/dV kernel:
    doubled, while they divide G, until the grid has two blocks per SM."""
    G = q.shape[2] // k.shape[2]
    blocks = -(-k.shape[1] // TILE) * k.shape[2] * k.shape[0]
    sms = _sm_count(k.device)
    ns = 1
    while G % (2 * ns) == 0 and blocks * ns < 2 * sms:
        ns *= 2
    return ns


def _check_launch(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"flash-attention {what} launch failed: cudaError {err}")


def flash_attention_fwd(q, k, v, *, causal=True, window=None, softcap=None, return_lse=False):
    """Attention forward (B3): o (B, Sq, Hq, hd) in q's dtype, and with
    ``return_lse`` also the row logsumexp (B, Sq, Hq) f32."""
    _check_opts(q, k, v, window, softcap)
    opts = dict(causal=causal, window=window, softcap=softcap)
    if _on_cpu(q, k, v):
        flash_attention_fwd.ref_calls += 1
        o, lse = flash_attention_fwd_ref(q, k, v, **opts)
    else:
        (q, k, v), tail = _cuda_args(q, k, v, **opts)
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        if q.dtype == torch.bfloat16:
            q, k, v = map(_aligned, (q, k, v))
            err = _sm90_library().flash_fwd_sm90(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                 o.data_ptr(), lse.data_ptr(), *tail)
        else:
            err = _library().flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                       lse.data_ptr(), *tail)
        _check_launch(err, "forward")
        flash_attention_fwd.launches += 1
        flash_attention_fwd.windowed_launches += window is not None
    return (o, lse) if return_lse else o


def flash_attention_dq(q, k, v, do, lse, delta, *, causal=True, window=None, softcap=None):
    """dQ (B4) from the forward's ``lse`` and ``delta = rowsum(dO * o)``."""
    _check_opts(q, k, v, window, softcap)
    opts = dict(causal=causal, window=window, softcap=softcap)
    if _on_cpu(q, k, v, do, lse, delta):
        flash_attention_dq.ref_calls += 1
        return flash_attention_dq_ref(q, k, v, do, lse, delta, **opts)
    (q, k, v, do), tail = _cuda_args(q, k, v, do, **opts)
    lse, delta = _rows_f32(lse, q, "lse"), _rows_f32(delta, q, "delta")
    dq = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        q, k, v, do = map(_aligned, (q, k, v, do))
        err = _sm90_library().flash_dq_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), *tail)
    else:
        err = _library().flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *tail)
    _check_launch(err, "dQ")
    flash_attention_dq.launches += 1
    flash_attention_dq.windowed_launches += window is not None
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal=True, window=None, softcap=None):
    """(dK, dV) (B5), summed over the query heads of each KV head.  In bf16
    one call launches the dK/dV kernel and the kernel that sums its slices;
    ``.launches`` counts the call."""
    _check_opts(q, k, v, window, softcap)
    opts = dict(causal=causal, window=window, softcap=softcap)
    if _on_cpu(q, k, v, do, lse, delta):
        flash_attention_dkv.ref_calls += 1
        return flash_attention_dkv_ref(q, k, v, do, lse, delta, **opts)
    (q, k, v, do), tail = _cuda_args(q, k, v, do, **opts)
    lse, delta = _rows_f32(lse, q, "lse"), _rows_f32(delta, q, "delta")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.bfloat16:
        q, k, v, do = map(_aligned, (q, k, v, do))
        ns = _dkv_slices(q, k)
        part = torch.empty((2, ns, *k.shape), dtype=torch.float32, device=k.device)
        err = _sm90_library().flash_dkv_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ns, *tail)
    else:
        err = _library().flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), *tail)
    _check_launch(err, "dK/dV")
    flash_attention_dkv.launches += 1
    flash_attention_dkv.windowed_launches += window is not None
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None, softcap=None):
    """(dq, dk, dv) of the forward that returned ``o`` and ``lse``: the row
    term ``delta`` (a plain op, as in the JAX package), then the dQ and the
    dK/dV kernels."""
    delta = attention_delta(o, do)
    opts = dict(causal=causal, window=window, softcap=softcap)
    dq = flash_attention_dq(q, k, v, do, lse, delta, **opts)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, **opts)
    return dq, dk, dv


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """Attention forward without autograd: o (B, Sq, Hq, hd)."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=softcap)


class FlashAttentionTrain(torch.autograd.Function):
    """The differentiable flash-attention op; saves ``(q, k, v, o, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=softcap,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand the cotangent over strided
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, *, causal=True, window=None, softcap=None):
    """Attention with gradients through the dQ and dK/dV kernels:
    o (B, Sq, Hq, hd) in q's dtype."""
    return FlashAttentionTrain.apply(q, k, v, causal, window, softcap)


def reset_counts() -> None:
    """Zero the launch and plain-call counters of the three kernel wrappers."""
    for fn in (flash_attention_fwd, flash_attention_dq, flash_attention_dkv):
        fn.launches = 0
        fn.windowed_launches = 0
        fn.ref_calls = 0


reset_counts()
