"""What the program's phase spans show of a training cell on the card, and
what recording them costs.

    python3 portbench/phase_report.py --workload sc2_3b.train_4k --seed <n> \
        [--rounds 5] [--timed-steps 8] [--out build/phase_report.json]

from the root of a checkout.  Builds the cell's program as its driver
does and drives it through the cell's first steps.  Then, ``--rounds``
times, with the span recorder off and on (on the profiler's clock), in
alternating order: ``--timed-steps`` steps timed on the host clock, the
device synchronised at both ends, and ``trace_steps`` steps under
``torch.profiler``; the garbage of earlier windows is collected before
each.  Prints each window's step time and idle; for the recorded traces
the six phase metrics, ``mfu.train`` and ``idle_share.train``, the share
of device time tied to a span, the phases' device time against the busy
time, where every pack, unpack and flash kernel was launched, and the
idle gaps by span; and the medians with and without the recorder.  The
whole report is written as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and pathlib.Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import bench, counts, phases, traffic  # noqa: E402
from portbench.drivers import train  # noqa: E402

READERS = ("optimizer_ms.train", "optimizer_roofline.train", "optimizer_launches.train",
           "forward_ms.train", "backward_ms.train", "exposed_sync_ms.train", "mfu.train",
           "idle_share.train")


def launched_in(w: phases.PhaseWindow) -> dict[str, dict[str, int]]:
    """For the pack, unpack and flash kernels: launches by the phase they
    were launched in."""
    out: dict[str, collections.Counter] = {k: collections.Counter()
                                           for k in ("pack_kernel", "unpack_kernel", "flash")}
    for (name, _, _), tie in zip(w.kernels, w.ties):
        kind = ("unpack_kernel" if "unpack_kernel" in name else "pack_kernel"
                if "pack_kernel" in name else "flash" if "flash_" in name else None)
        if kind:
            out[kind][tie[0] if tie else "no span"] += 1
    return {k: dict(v) for k, v in out.items()}


def report(w: phases.PhaseWindow, ctx: dict) -> dict:
    per = {ph: w.phase_seconds(ph) for ph in
           ("step", "forward", "backward", *phases.SYNC, "optimizer.update")}
    named = sum(per[ph][0] for ph in per if ph != "step")
    return {
        "metrics": {m: bench.metric_reader(m)(w, ctx) for m in READERS},
        "tied_share": w.tied_share(),
        "phase_ms": {ph: 1e3 * t / w.steps for ph, (t, _) in per.items()},
        "phase_launches": {ph: n / w.steps for ph, (_, n) in per.items()},
        "named_over_busy": named / w.busy_s,
        "launched_in": launched_in(w),
        "idle_by_span": w.idle_by_span(),
    }


def mark_us(n: int = 20_000) -> float:
    """Host µs of one mark of a phase span on the profiler's clock."""
    from repro_torch.core.profiler import TraceRecorder

    rec = TraceRecorder(profiler_clock=True)
    t0 = time.perf_counter()
    for _ in range(n):
        rec.phase_begin("sync.pack", device=0, nbytes=64, group=1, leaves=2)
        rec.phase_end("sync.pack", device=0)
    return (time.perf_counter() - t0) / (2 * n) * 1e6


def timed(prog, batches, steps: int, start: int, record: bool) -> float:
    """Seconds a step over ``steps`` untraced steps, recorder on or off."""
    from repro_torch.core.profiler import TraceRecorder

    phases.adopt(prog, TraceRecorder(profiler_clock=True) if record else None)
    gc.collect()
    train.sync(prog.device)
    t0 = time.perf_counter()
    for i in range(start, start + steps):
        prog.step(batches[i % len(batches)])
    train.sync(prog.device)
    return (time.perf_counter() - t0) / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="sc2_3b.train_4k")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--timed-steps", type=int, default=8)
    ap.add_argument("--out", default="build/phase_report.json")
    args = ap.parse_args(argv)
    cell = bench.cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    torch.set_num_threads(4)
    config, mix, w = cell.config, cell.traffic, cell.workload
    B, S = mix["batch"], mix["seq"]
    prog = train.Program(config, w["program"], device, args.seed, B * S)
    batches = traffic.lm_batches(mix, config["vocab"], args.seed, device)
    start = w["check_steps"]
    for i in range(start):
        prog.step(batches[i])
    ctx = {"config": config, "mix": mix, "chips": 1, "tokens_per_step": B * S,
           "step_flops": counts.step_flops(config, B, S),
           "wire_itemsize": train.DTYPES[w["program"]["comm_dtype"]].itemsize, **prog.counters()}
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "mark_us": mark_us(), "windows": []}
    for rnd in range(args.rounds):
        for record in ((False, True) if rnd % 2 == 0 else (True, False)):
            step_s = timed(prog, batches, args.timed_steps, start, record)
            start += args.timed_steps
            win = phases.traced_window(prog, batches, w["trace_steps"], start, record)
            start += w["trace_steps"]
            row = {"record": record, "timed_step_s": step_s, "traced_step_s": win.wall_s / win.steps,
                   "busy_s_per_step": win.busy_s / win.steps,
                   "kernels_per_step": len(win.kernels) / win.steps,
                   "marks_per_step": 2 * len(win.spans) / win.steps, "idle_gaps": win.idle_gaps()}
            if record:
                row.update(report(win, ctx))
            out["windows"].append(row)
            print(f"[phases] round {rnd} recorder {'on ' if record else 'off'}: step "
                  f"{step_s * 1e3:.3f} ms untraced, {row['traced_step_s'] * 1e3:.3f} ms traced, "
                  f"busy {row['busy_s_per_step'] * 1e3:.3f} ms, "
                  f"{row['kernels_per_step']:.0f} kernels a step", flush=True)
    prog.close()
    for key in ("timed_step_s", "traced_step_s", "busy_s_per_step"):
        out[key + "_median"] = {
            side: statistics.median(r[key] for r in out["windows"] if r["record"] == on)
            for side, on in (("on", True), ("off", False))}
    last = [r for r in out["windows"] if r["record"]][-1]
    print("[phases] metrics (last recorded window): " + json.dumps(last["metrics"]))
    print(f"[phases] tied share {last['tied_share']:.5f}; named phases / busy "
          f"{last['named_over_busy']:.5f}; phase ms {json.dumps(last['phase_ms'])}")
    print(f"[phases] launched in: {json.dumps(last['launched_in'])}")
    print(f"[phases] idle by span: {json.dumps(last['idle_by_span'])}")
    print(f"[phases] a mark {out['mark_us']:.3f} us, {last['marks_per_step']:.0f} marks a step")
    for key in ("timed_step_s", "traced_step_s", "busy_s_per_step"):
        m = out[key + "_median"]
        print(f"[phases] median {key}: on {m['on'] * 1e3:.3f} ms, off {m['off'] * 1e3:.3f} ms")
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
