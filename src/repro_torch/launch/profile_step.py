"""Where a training step's time goes on the card: ``torch.profiler`` over
a few steady steps of the launcher's configuration.

    python -m repro_torch.launch.profile_step --arch tinyllama-1.1b --batch 4 \\
        --seq 512 --fuse arena --policy mg_wfbp --fabric gpu_nccl --steps 3 \\
        [--json-out PATH] [--trace-out PATH]

Takes every flag of ``repro_torch.launch.train``; ``--steps`` is the
number of profiled steps, run after ``WARMUP`` unprofiled ones.  Called
from Python, ``main(argv, overrides={'n_layers': 8})`` replaces fields of
the arch config, as ``launch.train.prepare`` does.  Prints
the wall time per step, the device's busy and idle shares of that wall
time (union of kernel intervals), device time by kernel class and the
top kernels by device time.  CUDA only: a profile without device events
is refused rather than reported.
"""

from __future__ import annotations

import argparse
import json
import re
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .train import prepare

WARMUP = 2  # unprofiled steps before the profiled ones
TOP = 15  # kernels listed by device time

#: Kernel classes, first match wins (lower-cased kernel names).
CLASSES = (
    ("flash_attention", ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")),
    ("rglru", ("rglru_fwd_kernel", "rglru_bwd_kernel")),
    ("rwkv6_wkv", ("wkv_fwd_kernel", "wkv_bwd_state_kernel", "wkv_bwd_decay_kernel")),
    ("comm_pack", ("pack_kernel", "unpack_kernel")),
    ("nccl", ("nccl",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
    ("softmax/reduce", ("softmax", "reduce", "logsumexp")),
    ("copy/cast", ("copy", "cast", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main(argv: list[str] | None = None, overrides: dict | None = None) -> dict:
    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--json-out", default=None)
    own.add_argument("--trace-out", default=None)
    mine, rest = own.parse_known_args(argv)
    setup = prepare(rest, overrides=overrides)
    try:
        if setup.device.type != "cuda":
            raise RuntimeError("the profile measures the card: run it on cuda")
        steps = setup.args.steps
        for i in range(WARMUP):
            setup.step_fn(setup.batch(i))
        torch.cuda.synchronize(setup.device)
        batches = [setup.batch(WARMUP + i) for i in range(steps)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches:
                setup.step_fn(b)
            torch.cuda.synchronize(setup.device)
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        setup.close()

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events; time with CUDA events instead")
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    by_class: dict[str, float] = {}
    for name, ts in by_name.items():
        by_class[kernel_class(name)] = by_class.get(kernel_class(name), 0.0) + sum(ts)
    device_us = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:TOP]
    report = {
        "config": " ".join(rest) + (f" overrides={overrides}" if overrides else ""),
        "card": torch.cuda.get_device_name(setup.device),
        "steps": steps,
        "step_ms": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernel_ms_per_step_by_class": {k: v / steps / 1e3 for k, v in
                                         sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels": [
            {"name": re.sub(r"\s+", " ", n)[:120], "calls_per_step": len(ts) / steps,
             "ms_per_step": sum(ts) / steps / 1e3}
            for n, ts in top
        ],
        "kernel_ms_per_step_total": device_us / steps / 1e3,
    }
    print(f"[profile] {report['config']}")
    print(f"[profile] step {report['step_ms']:.1f} ms wall; device busy "
          f"{report['device_busy_ms_per_step']:.1f} ms/step, idle share "
          f"{report['device_idle_share']:.3f}")
    for k, v in report["kernel_ms_per_step_by_class"].items():
        print(f"[profile]   {k:15s} {v:9.3f} ms/step")
    for t in report["top_kernels"]:
        print(f"[profile]   {t['ms_per_step']:9.3f} ms/step  x{t['calls_per_step']:6.1f}  {t['name']}")
    print(json.dumps(report))
    if mine.json_out:
        with open(mine.json_out, "w") as fh:
            json.dump(report, fh, indent=1)
    if mine.trace_out:
        prof.export_chrome_trace(mine.trace_out)
    return report


if __name__ == "__main__":
    main()
