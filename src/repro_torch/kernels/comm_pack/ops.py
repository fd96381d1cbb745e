"""Public ops for the gradient-arena wire path: the CUDA kernels of
``csrc/comm_pack.cu`` for tensors on the card, the plain versions of
``ref.py`` for tensors on the CPU (counterpart of
``repro/kernels/comm_pack/ops.py``).

Which path runs follows from where the tensors lie, and from nothing
else: a CUDA tensor launches the kernel or raises.  ``pack_arena.launches``
and ``unpack_arena.launches`` count kernel launches;
``pack_arena.ref_calls`` and ``unpack_arena.ref_calls`` count calls that
took the plain version.

The kernel library is compiled with ``nvcc`` for ``sm_90a`` at first use
into ``build/`` at the repository root (named by a hash of the source, so
an edited source is rebuilt) and loaded with ``ctypes`` (``.._build``).
"""

from __future__ import annotations

import ctypes
import pathlib
from collections import OrderedDict
from typing import Sequence

import torch

from .. import _build
from .ref import pack_arena_ref, unpack_arena_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "comm_pack.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FLAG_BF16 = 1
_FLAG_VEC = 2
_VEC = 8  # elements per vector access in the kernel

_lib: ctypes.CDLL | None = None
#: Device copies of the kernels' row tables, keyed by their content (every
#: pointer, offset, size and flag) and the device, least recently used
#: first.  A training step reuses one table per group and direction.
_TABLES: OrderedDict[tuple, torch.Tensor] = OrderedDict()
_TABLES_MAX = 256


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernel library if this source has not been built yet.

    Returns (library path, compiler log); the log holds ptxas's register
    and spill report when a build ran, and is empty otherwise."""
    return _build.build(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        lib.comm_pack_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.comm_pack_pack.restype = ctypes.c_int
        lib.comm_pack_unpack.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.comm_pack_unpack.restype = ctypes.c_int
        _lib = lib
    return _lib


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"comm_pack kernels take float32/bfloat16 tensors, got {t.dtype}")
    return _DTYPE_CODE[t.dtype]


def _aligned(*tensors: torch.Tensor | None) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _check_exact_packing(offsets: Sequence[int], sizes: Sequence[int], size: int) -> None:
    off = 0
    for o, n in zip(offsets, sizes):
        if int(o) != off:
            raise ValueError(
                f"the CUDA arena kernels need exact packing: part at offset {o}, expected {off}"
            )
        off += n
    if off != size:
        raise ValueError(f"parts cover {off} elements, arena has {size}")


def _table(rows: list[list[int]], device: torch.device) -> torch.Tensor:
    """Device copy of the row table: uploaded the first time these rows
    are seen on ``device``, reused from ``_TABLES`` after that."""
    key = (device, tuple(tuple(r) for r in rows))
    table = _TABLES.get(key)
    if table is not None:
        _TABLES.move_to_end(key)
        return table
    table = torch.tensor(rows, dtype=torch.int64).reshape(-1).to(device)
    _TABLES[key] = table
    if len(_TABLES) > _TABLES_MAX:
        _TABLES.popitem(last=False)
    return table


def _check_cuda(parts: Sequence[torch.Tensor], device: torch.device) -> None:
    for p in parts:
        if p.device != device:
            raise ValueError(f"tensor on {p.device}, expected {device}")
        if not p.is_contiguous():
            raise ValueError("comm_pack kernels need contiguous tensors")
        _dtype_code(p)


def pack_arena(
    parts: Sequence[torch.Tensor],
    offsets: Sequence[int],
    size: int,
    comm_dtype: torch.dtype,
    residuals: Sequence[torch.Tensor] | None = None,
) -> torch.Tensor:
    """Pack one group's parts into a new flat wire arena.

    Fuses the wire-dtype cast and, when ``residuals`` (f32, one per part,
    same sizes) is given, the error-feedback accumulate/update: the
    residuals are updated **in place**.
    """
    device = parts[0].device
    if device.type == "cpu":
        pack_arena.ref_calls += 1
        arena, new_res = pack_arena_ref(parts, offsets, size, comm_dtype, residuals)
        if residuals is not None:
            for r, nr in zip(residuals, new_res):
                r.copy_(nr.view(r.shape))
        return arena
    if device.type != "cuda":
        raise ValueError(f"comm_pack runs on cuda or cpu tensors, got {device}")
    sizes = [p.numel() for p in parts]
    _check_exact_packing(offsets, sizes, size)
    _check_cuda(parts, device)
    if residuals is not None:
        _check_cuda(residuals, device)
        for r, n in zip(residuals, sizes):
            if r.dtype != torch.float32 or r.numel() != n:
                raise ValueError("residuals must be float32 with the parts' sizes")
    arena = torch.empty(size, dtype=comm_dtype, device=device)
    wire_code = _dtype_code(arena)
    rows = []
    for i, (p, off, n) in enumerate(zip(parts, offsets, sizes)):
        if n == 0:
            continue
        r = residuals[i] if residuals is not None else None
        vec = int(off) % _VEC == 0 and _aligned(p, r, arena)
        rptr = r.data_ptr() if r is not None else 0
        rows.append([p.data_ptr(), rptr, rptr, int(off), n,
                     _dtype_code(p) * _FLAG_BF16 | (_FLAG_VEC if vec else 0)])
    if not rows:
        return arena
    table = _table(rows, device)
    err = _library().comm_pack_pack(
        table.data_ptr(), len(rows), arena.data_ptr(), size, wire_code,
        int(residuals is not None), torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"comm_pack pack launch failed: cudaError {err}")
    pack_arena.launches += 1
    return arena


def unpack_arena(
    arena: torch.Tensor,
    offsets: Sequence[int],
    outs: Sequence[torch.Tensor],
    scale: float = 1.0,
) -> Sequence[torch.Tensor]:
    """Write ``cast(f32(arena slot) * scale)`` into each of ``outs`` (any
    shape, their own dtypes), in place; returns ``outs``."""
    if arena.device.type == "cpu":
        unpack_arena.ref_calls += 1
        slots = [(int(o), t.numel()) for o, t in zip(offsets, outs)]
        for t, v in zip(outs, unpack_arena_ref(arena, slots, [t.dtype for t in outs], scale)):
            t.copy_(v.view(t.shape))
        return outs
    if arena.device.type != "cuda":
        raise ValueError(f"comm_pack runs on cuda or cpu tensors, got {arena.device}")
    sizes = [t.numel() for t in outs]
    _check_exact_packing(offsets, sizes, arena.numel())
    _check_cuda([arena, *outs], arena.device)
    rows = []
    for t, off, n in zip(outs, offsets, sizes):
        if n == 0:
            continue
        vec = int(off) % _VEC == 0 and _aligned(t, arena)
        rows.append([t.data_ptr(), 0, 0, int(off), n,
                     _dtype_code(t) * _FLAG_BF16 | (_FLAG_VEC if vec else 0)])
    if not rows:
        return outs
    table = _table(rows, arena.device)
    err = _library().comm_pack_unpack(
        table.data_ptr(), len(rows), arena.data_ptr(), arena.numel(), _dtype_code(arena),
        float(scale), torch.cuda.current_stream(arena.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"comm_pack unpack launch failed: cudaError {err}")
    unpack_arena.launches += 1
    return outs


def reset_counts() -> None:
    """Zero the launch and plain-call counters of both wrappers."""
    for fn in (pack_arena, unpack_arena):
        fn.launches = 0
        fn.ref_calls = 0


reset_counts()
