"""Public ops for the WKV6 recurrence: the CUDA kernels of
``csrc/rwkv6_wkv.cu`` for tensors on the card, the plain versions of
``ref.py`` for tensors on the CPU (counterpart of
``repro/kernels/rwkv6_wkv/ops.py``).

Which path runs follows from where the tensors lie, and from nothing
else: a CUDA tensor launches the kernel or raises.  The forward has two
designs, which the library picks by T alone (never by B, so a row's bits
do not depend on the rows batched with it): for T up to ``step_max_t()``
(the decode step, T = 1) the step kernel ``wkv_step_kernel``, one launch,
one pass over the state; past it the chunked pair
``wkv_fwd_state_kernel`` + ``wkv_fwd_out_kernel`` (training, prefill).  The
backward, which only training runs, is the chunked kernels.  Each kernel's
wrapper (``wkv_fwd``, ``wkv_bwd``) counts its calls that launched in
``.launches`` (a call that launches several kernels counts once) and its
calls that took the plain version in ``.ref_calls``; ``wkv_fwd`` also
counts its calls that took the step kernel in ``.step_launches``.
``reset_counts()`` zeroes them.

``wkv`` is the differentiable op (``WKV6Function``): its forward launches
``wkv_fwd`` and saves ``(r, k, v, w, u, s0)`` and, on the card, the state at
the start of every 64-step chunk that the forward computed on the way (the
step kernel computes none: its one chunk starts from ``s0``, handed over
as that state, or none without ``s0``); its backward launches ``wkv_bwd``
from them.  The kernels take r, k,
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
from .ref import CHUNK, SUB, wkv_bwd_ref, wkv_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "rwkv6_wkv.cu"
HEAD_SIZES = (32, 64)

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
        lib.wkv_bwd.argtypes = [p] * 9 + [i] + [p] * 8 + [i] * 5 + [p]
        lib.wkv_fwd.restype = lib.wkv_bwd.restype = ctypes.c_int
        lib.wkv_fwd_chunk.restype = lib.wkv_fwd_sub.restype = ctypes.c_int
        lib.wkv_step_max_t.restype = ctypes.c_int
        # the scratches are sized by CHUNK, and the CPU mirrors follow CHUNK and SUB
        built = (lib.wkv_fwd_chunk(), lib.wkv_fwd_sub())
        if built != (CHUNK, SUB):
            raise RuntimeError(f"{SOURCE.name} chunks the forward as (chunk, sub) {built}, "
                               f"ref.py as {(CHUNK, SUB)}")
        # the step kernel's walk is one chunk: s0 is the backward's chunk state
        if not 0 <= lib.wkv_step_max_t() <= CHUNK:
            raise RuntimeError(f"{SOURCE.name} takes the step kernel up to T "
                               f"{lib.wkv_step_max_t()}, past one chunk of {CHUNK}")
        _lib = lib
    return _lib


def step_max_t() -> int:
    """The longest T that the forward runs in the step kernel
    (``kStepMaxT`` of ``csrc/rwkv6_wkv.cu``); builds the library."""
    return _library().wkv_step_max_t()


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
    initial state ``s0`` (zero when None).  On the card: for T up to
    ``step_max_t()`` the step kernel (the recurrence step by step, as
    ``wkv_ref``), past it the chunked kernels, with the state at the start
    of every 64-step chunk in a scratch tensor (``wkv_chunked_ref`` is
    their arithmetic on the CPU)."""
    return _wkv_fwd(r, k, v, w, u, s0)[:2]


def _wkv_fwd(r, k, v, w, u, s0):
    """``wkv_fwd``, and the chunk states that the backward can take: the
    chunked kernels' scratch, or for the step kernel ``s0`` as the one
    chunk's state (None without ``s0``, and on the CPU)."""
    B, T, H, K = _check_shapes({"r": r, "k": k, "v": v, "w": w}, u, {"s0": s0})
    if _on_cpu(r, k, v, w, u, s0):
        wkv_fwd.ref_calls += 1
        return (*wkv_ref(r, k, v, w, u, s0), None)
    (r, k, v, w, u, s0), bf16 = _kernel_inputs(r, k, v, w, u, K, s0=s0)
    out = torch.empty(B, T, H, K, dtype=torch.float32, device=r.device)
    s_final = torch.empty(B, H, K, K, dtype=torch.float32, device=r.device)
    step = T <= step_max_t()
    chunk_states = None if step else torch.empty(B, H, -(-T // CHUNK), K, K,
                                                 dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    _check_launch(_library().wkv_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), _ptr(s0),
        out.data_ptr(), s_final.data_ptr(), _ptr(chunk_states), B, T, H, K, bf16, stream),
        "forward")
    wkv_fwd.launches += 1
    if step:
        wkv_fwd.step_launches += 1
        chunk_states = None if s0 is None else s0[:, :, None]
    return out, s_final, chunk_states


def wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, s0: torch.Tensor | None, dout: torch.Tensor,
            ds_final: torch.Tensor | None = None, chunk_states: torch.Tensor | None = None):
    """Gradient of ``wkv_fwd`` from the cotangents ``dout`` (B, T, H, K) and
    ``ds_final`` (B, H, K, K; None means zero): (dr, dk, dv, dw, du, ds0),
    f32; ds0 is None when ``s0`` is None.  On the card: the chunked
    backward kernels (``wkv_bwd_chunked_ref`` is their arithmetic on the
    CPU).  ``chunk_states`` is the forward's scratch for the same inputs,
    (B, H, ceil(T / 64), K, K) f32; without it the kernels first compute
    it (one more launch within the call)."""
    B, T, H, K = _check_shapes({"r": r, "k": k, "v": v, "w": w, "dout": dout}, u,
                               {"s0": s0, "ds_final": ds_final})
    if _on_cpu(r, k, v, w, u, s0, dout, ds_final, chunk_states):
        wkv_bwd.ref_calls += 1
        return wkv_bwd_ref(r, k, v, w, u, s0, dout, ds_final)
    (r, k, v, w, u, s0, dout, ds_final, chunk_states), bf16 = _kernel_inputs(
        r, k, v, w, u, K, s0=s0, dout=dout, ds_final=ds_final, chunk_states=chunk_states)
    dev, NC = r.device, -(-T // CHUNK)
    if chunk_states is not None and chunk_states.shape != (B, H, NC, K, K):
        raise ValueError(f"chunk_states is {tuple(chunk_states.shape)}, expected {(B, H, NC, K, K)}")
    f32 = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)
    states_ready = chunk_states is not None
    if not states_ready:
        chunk_states = f32(B, H, NC, K, K)
    dr, dk, dv, dw = (f32(B, T, H, K) for _ in range(4))
    du, ds0, ds_chunks, part = f32(H, K), f32(B, H, K, K), f32(B, H, NC, K, K), f32(B, H, NC, K)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check_launch(_library().wkv_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), _ptr(s0),
        dout.data_ptr(), _ptr(ds_final), chunk_states.data_ptr(), int(states_ready),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(), ds_chunks.data_ptr(), part.data_ptr(), B, T, H, K, bf16, stream),
        "backward")
    wkv_bwd.launches += 1
    return dr, dk, dv, dw, du, (None if s0 is None else ds0)


class WKV6Function(torch.autograd.Function):
    """The differentiable WKV6; saves ``(r, k, v, w, u, s0)`` and the
    forward's chunk states (None on the CPU)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        out, s_final, chunk_states = _wkv_fwd(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0, chunk_states)
        ctx.set_materialize_grads(False)  # an unused s_final passes no zeros
        return out, s_final

    @staticmethod
    def backward(ctx, dout, ds_final):
        r, k, v, w, u, s0, chunk_states = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        # autograd may hand the cotangent over strided
        grads = wkv_bwd(r, k, v, w, u, s0, dout.contiguous(), ds_final, chunk_states)
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
    wkv_fwd.step_launches = 0


reset_counts()
