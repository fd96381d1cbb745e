"""Public op for the AdamW step: the CUDA kernel of ``csrc/adamw.cu`` for
parameters on the card, the plain version of ``ref.py`` for the others.

Which path runs follows from where the parameters lie, and from nothing
else.  CUDA tensors, and DTensors whose local shards are CUDA tensors (the
kernel then updates the shards), launch the kernel or raise; CPU and
``meta`` tensors, DTensors over them included, take the plain loop.
``adamw_step.launches`` counts kernel launches (one a step up to
``MAX_LEAVES`` leaves); ``adamw_step.ref_calls`` counts calls that took the
plain version.

The host side of a step.  The leaf table (each leaf's pointers, size,
dtypes and first chunk, and the cut of the leaves into launches) is built
once per parameter set and kept while its ``owner`` lives (``adamw_update``
hands its optimizer state; without an owner it is built each call).  A
step checks that the parameters and moments are the objects the table was
built from, that the parameters still lie where they lay (a moment is
written in place and never given other storage, so its object stands for
its address) and that the gradients have the table's dtypes, sizes and
device, and writes only the gradients' addresses into a copy of the table;
any other parameter set builds the table anew.  The table reaches the card inside the kernel's
parameters, so a step uploads nothing, waits for nothing and allocates
nothing on the card.

The kernel library is compiled with ``nvcc`` for ``sm_90a`` at first use
into ``build/`` at the repository root and loaded with ``ctypes``
(``.._build``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import operator
import pathlib
import weakref
from typing import Sequence

import torch

from .. import _build
from .ref import adamw_step_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "adamw.cu"

MAX_LEAVES = 512  # kMaxLeaves: the rows one launch's parameters hold
CHUNK = 16384  # kChunk: elements a block
_COLS = 7  # [param, grad, m, v, elements, first chunk, flags]
_PARAM_BF16 = 1
_GRAD_BF16 = 2
_BF16 = {torch.float32: False, torch.bfloat16: True}

_lib: ctypes.CDLL | None = None
#: Leaf tables by their owner's ``id``, each dropped when its owner is collected.
_LAYOUTS: dict[int, "_Layout"] = {}
_ptr, _dtype, _is = torch.Tensor.data_ptr, operator.attrgetter("dtype"), operator.is_


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernel library if this source has not been built yet.

    Returns (library path, compiler log); the log holds ptxas's register
    and spill report when a build ran, and is empty otherwise."""
    return _build.build(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        lib.adamw_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     *[ctypes.c_double] * 7, ctypes.c_void_p]
        lib.adamw_launch.restype = ctypes.c_int
        lib.adamw_max_leaves.argtypes = []
        lib.adamw_max_leaves.restype = ctypes.c_int
        lib.adamw_chunk.argtypes = []
        lib.adamw_chunk.restype = ctypes.c_longlong
        if (lib.adamw_max_leaves(), lib.adamw_chunk()) != (MAX_LEAVES, CHUNK):
            raise RuntimeError(
                f"csrc/adamw.cu holds {lib.adamw_max_leaves()} leaves and {lib.adamw_chunk()} "
                f"elements a chunk, ops.py {MAX_LEAVES} and {CHUNK}"
            )
        _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch: leaves ``[first, stop)`` of the step, leaf
    ``first + k`` owning chunks ``[chunk0[k], chunk0[k] + ceil(n / chunk))``
    of the launch's ``n_chunks``."""

    first: int
    stop: int
    chunk0: tuple[int, ...]
    n_chunks: int


def plan_launches(numels: Sequence[int], max_leaves: int = MAX_LEAVES,
                  chunk: int = CHUNK) -> list[Launch]:
    """Cut the leaves, in order, into launches of at most ``max_leaves``
    leaves, each leaf owning ``ceil(n / chunk)`` chunks of ``chunk``
    elements (a leaf of no elements owns none).  Launches that would own no
    chunk are left out."""
    launches = []
    for first in range(0, len(numels), max_leaves):
        starts = list(itertools.accumulate(
            (-(-int(n) // chunk) for n in numels[first:first + max_leaves]), initial=0))
        total = starts.pop()
        assert total < 2**31, "a launch's chunks fill the grid's x dimension"
        if total:
            launches.append(Launch(first, first + len(starts), tuple(starts), total))
    return launches


def _flag(dtype: torch.dtype, what: str) -> bool:
    if dtype not in _BF16:
        raise TypeError(f"the AdamW kernel takes float32/bfloat16 {what}s, got {dtype}")
    return _BF16[dtype]


class _Layout:
    """The leaf table of one parameter set: a ``ctypes`` array of rows with
    every column but the gradients' addresses filled, and its launches.
    ``params``, ``ms`` and ``vs`` are the caller's objects (DTensors among
    them), ``local`` the plain tensors the kernel reads and writes."""

    def __init__(self, params, ms, vs, local):
        lp, lg, lm, lv = local
        device = lp[0].device
        rows = []
        for i, (p, g, m, v) in enumerate(zip(lp, lg, lm, lv)):
            n = p.numel()
            for t, what in ((p, "parameter"), (m, "first moment"), (v, "second moment")):
                if t.device != device or not t.is_contiguous():
                    raise ValueError(f"leaf {i}: the {what} is not a contiguous tensor on {device}")
            if m.dtype != torch.float32 or v.dtype != torch.float32 or m.numel() != n \
                    or v.numel() != n:
                raise ValueError(f"leaf {i}: the moments must be float32 with the parameter's size")
            flags = (_PARAM_BF16 if _flag(p.dtype, "parameter") else 0) \
                | (_GRAD_BF16 if _flag(g.dtype, "gradient") else 0)
            rows.append([p.data_ptr(), 0, m.data_ptr(), v.data_ptr(), n, 0, flags])
        self.objects = (list(params), list(ms), list(vs))
        self.param_ptrs = list(map(_ptr, lp))
        self.grad_dtypes = list(map(_dtype, lg))
        self.device_index = lp[0].get_device()
        self.numels = [r[4] for r in rows]
        self.launches = plan_launches(self.numels)
        for launch in self.launches:
            for k, c0 in enumerate(launch.chunk0):
                rows[launch.first + k][5] = c0
        self.table = (ctypes.c_int64 * (_COLS * len(rows)))(*[x for r in rows for x in r])

    def holds(self, params, ms, vs, lparams, lgrads) -> bool:
        """Whether the table is this step's: the same parameter and moment
        objects, the parameters where they lay, the gradients' dtypes."""
        ps, m0, v0 = self.objects
        return (len(params) == len(ps) and all(map(_is, params, ps)) and all(map(_is, ms, m0))
                and all(map(_is, vs, v0)) and list(map(_ptr, lparams)) == self.param_ptrs
                and list(map(_dtype, lgrads)) == self.grad_dtypes)


def _layout(owner, params, grads, ms, vs) -> tuple[_Layout, Sequence[torch.Tensor]]:
    """``owner``'s leaf table, built anew unless it holds this step; and the
    gradients as plain tensors."""
    lp, lg = _locals(params, grads)
    layout = _LAYOUTS.get(id(owner)) if owner is not None else None
    if layout is None or not layout.holds(params, ms, vs, lp, lg):
        layout = _Layout(params, ms, vs, (lp, lg, *_locals(ms, vs)))
        if owner is not None:
            if id(owner) not in _LAYOUTS:
                weakref.finalize(owner, _LAYOUTS.pop, id(owner), None)
            _LAYOUTS[id(owner)] = layout
    return layout, lg


def _locals(*lists: Sequence[torch.Tensor]) -> tuple[Sequence[torch.Tensor], ...]:
    """The lists with each DTensor replaced by its local shard; as they are
    where the first tensor of each is a plain one (a DTensor after it has no
    data pointer, and the table's build raises on it)."""
    if all(type(ts[0]) in (torch.Tensor, torch.nn.Parameter) for ts in lists):
        return lists
    from torch.distributed.tensor import DTensor

    return tuple([t.to_local() if isinstance(t, DTensor) else t for t in ts] for ts in lists)


def adamw_step(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    ms: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    lr: float,
    b1: float,
    b2: float,
    eps: float,
    weight_decay: float,
    bc1: float,
    bc2: float,
    owner: object = None,
) -> None:
    """One AdamW step over the leaves, in place, as ``adamw_step_ref``
    computes it (``bc1``, ``bc2``: the caller's bias corrections).  The leaf
    table is kept while ``owner`` lives (any object that can be weakly
    referenced; the moments' holder is the natural one)."""
    if len({len(params), len(grads), len(ms), len(vs)}) != 1:
        raise ValueError("one gradient and two moments a parameter")
    if not params:
        return
    if params[0].device.type != "cuda":
        adamw_step.ref_calls += 1
        adamw_step_ref(params, grads, ms, vs, lr, b1, b2, eps, weight_decay, bc1, bc2)
        return
    lib = _library()
    stream = torch.cuda.current_stream(params[0].device).cuda_stream
    _launch(lib, stream, owner, params, grads, ms, vs, lr, b1, b2, eps, weight_decay, bc1, bc2)


def _launch(lib, stream: int, owner, params, grads, ms, vs, *scalars: float) -> None:
    """Fill this step's table and make ``lib``'s launches on ``stream``
    (``lib`` is the kernel library; the CPU tests hand a stand-in)."""
    layout, grads = _layout(owner, params, grads, ms, vs)
    if list(map(torch.Tensor.numel, grads)) != layout.numels \
            or not all(map(torch.Tensor.is_contiguous, grads)) \
            or set(map(torch.Tensor.get_device, grads)) != {layout.device_index}:
        raise ValueError("the gradients must be contiguous tensors with their parameters' sizes "
                         "on their device")
    table = type(layout.table).from_buffer_copy(layout.table)
    table[1::_COLS] = list(map(_ptr, grads))
    base = ctypes.addressof(table)
    for launch in layout.launches:
        err = lib.adamw_launch(base + launch.first * _COLS * 8, launch.stop - launch.first,
                               launch.n_chunks, *scalars, stream)
        if err:
            raise RuntimeError(f"AdamW launch failed: cudaError {err}")
        adamw_step.launches += 1


def reset_counts() -> None:
    """Zero the wrapper's launch and plain-call counters."""
    adamw_step.launches = 0
    adamw_step.ref_calls = 0


reset_counts()
