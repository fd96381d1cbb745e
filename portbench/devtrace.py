"""What a traced window did on the device, from ``torch.profiler``'s events
of the device's activity alone: the kernels with their intervals, the
busy time (the union of the kernels' intervals), device time by kernel
class, the operations that took most time, and the longest idle gaps by
the CUDA runtime call that the host made last before each gap closed.

The classes and the union are the arithmetic of the program's own
profile (``launch/profile_step.py``), copied here so that the yardstick
does not move with the program.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

#: Kernel classes, first match wins (lower-cased kernel names).
CLASSES = (
    ("flash_attention", ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                         "flash_fwd_sm90_kernel", "flash_dq_sm90_kernel", "flash_dkv_sm90_kernel",
                         "flash_dkv_sum_kernel")),
    ("rglru", ("rglru_fwd_kernel", "rglru_bwd_kernel", "rglru_step_kernel")),
    ("rwkv6_wkv", ("wkv_step_kernel", "wkv_fwd_state_kernel", "wkv_fwd_out_kernel",
                   "wkv_bwd_state_kernel", "wkv_bwd_dv_kernel", "wkv_bwd_grad_kernel",
                   "wkv_bwd_du_kernel")),
    ("comm_pack", ("pack_kernel", "unpack_kernel")),
    ("nccl", ("nccl",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
    ("softmax/reduce", ("softmax", "reduce", "logsumexp")),
    ("copy/cast", ("copy", "cast", "fill", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
TOP = 10
GAP_MIN_US = 2.0  # idle gaps shorter than this are launch jitter, not host stalls


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


@dataclasses.dataclass
class Window:
    """A traced window: ``kernels`` are (name, start_us, end_us) on the
    device; ``host_ops`` (name, start_us, end_us) on the host; ``wall_s``
    is the window's length on the host clock, device synchronised."""

    kernels: list[tuple[str, float, float]]
    host_ops: list[tuple[str, float, float]]
    wall_s: float
    steps: int

    @property
    def busy_s(self) -> float:
        return union_us([(a, b) for _, a, b in self.kernels]) / 1e6

    def seconds_where(self, keys: tuple[str, ...]) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds one of ``keys``."""
        t, n = 0.0, 0
        for name, a, b in self.kernels:
            if any(k in name for k in keys):
                t += (b - a) / 1e6
                n += 1
        return t, n

    def device_ops(self) -> list[list]:
        by: dict[str, float] = {}
        for name, a, b in self.kernels:
            key = re.sub(r"\s+", " ", name)[:120]
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list[list]:
        """Idle device time between kernels, summed by what the host did
        last before the gap closed (the runtime call that started latest:
        ``cudaLaunchKernel`` when the launch came late, a synchronising call
        when the host waited) and the class of the kernel that closed it."""
        ks = sorted((a, b, name) for name, a, b in self.kernels)
        ops = sorted(self.host_ops, key=lambda o: o[1])
        starts = [o[1] for o in ops]
        by: dict[str, float] = {}
        end = ks[0][1] if ks else 0.0
        for a, b, name in ks[1:]:
            if a - end >= GAP_MIN_US:
                i = bisect.bisect_right(starts, a)
                key = f"{ops[i - 1][0] if i else 'no host call'} > {kernel_class(name)}"
                by[key] = by.get(key, 0.0) + (a - end) / 1e6
            end = max(end, b)
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def from_profile(prof, wall_s: float, steps: int) -> Window:
    """The window of a ``torch.profiler.profile`` run: device events are
    kernels, the rest (the runtime calls) host operations."""
    import torch

    kernels, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, float(tr.start), float(tr.end)))
        elif not e.name.startswith("Activity Buffer"):
            host.append((e.name, float(tr.start), float(tr.end)))
    return Window(kernels=kernels, host_ops=host, wall_s=wall_s, steps=steps)
