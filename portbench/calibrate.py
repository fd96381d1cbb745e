"""The readings that the limits of a training cell are set from, at the
cell's own size, on the chip (the benchmark's runs do not run this):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds ...] [--fault-seeds ...] --out FILE

* the program's numbers on each of ``--seeds`` (one program, its weights
  and optimizer state started again for each seed);
* the control on ``--control-seeds``: the reference put in the program's
  place with its products in fp8 (``reference.common.Matmul``);
* the half-batch fault on ``--fault-seeds``: the reference with the loss
  taken over the first half of each batch's tokens; a step that returns
  its state unchanged reads ``change_gap`` 1 with no run.

Every number is against the float32 reference of the same seed.  Writes
one JSON object to ``--out``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and pathlib.Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

TOP_LEAVES = 5


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def top_gaps(prog: dict, ref: dict) -> list:
    """The leaves with the largest gaps, with both norms."""
    import statistics

    med = statistics.median(ref.values())
    gaps = sorted(((abs(prog[n] - ref[n]) / max(ref[n], med), n, prog[n], ref[n]) for n in ref),
                  reverse=True)
    return [[n, g, p, r] for g, n, p, r in gaps[:TOP_LEAVES]]


def summary(prog: dict, ref: dict) -> dict:
    from portbench import check

    out = {k: v["value"] for k, v in check.train_numbers(prog, ref).items()}
    out["top_grad"] = top_gaps(prog["grad_norms"], ref["grad_norms"])
    out["top_change"] = top_gaps(prog["change_norms"], ref["change_norms"])
    out["losses"] = prog["losses"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from portbench import bench
    from portbench.drivers import train

    cell = bench.cell(args.workload, ROOT)
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device(args.device)
    config, mix, w = cell.config, cell.traffic, cell.workload
    n = w["check_steps"]
    report = {"cell": cell.name, "runs": {},
              "card": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    timings = report["timings"] = {}

    def program_readings(seed_list, tag):
        t = time.perf_counter()
        prog = train.Program(config, w["program"], device, seed_list[0],
                             mix["batch"] * mix["seq"])
        out = {}
        for s in seed_list:
            prog.reseed(s)
            batches = train.traffic.lm_batches(mix, config["vocab"], s, device)
            out[s] = prog.first_steps(batches[:n])
        prog.close()
        del prog
        timings[tag] = (time.perf_counter() - t) / len(seed_list)
        return out

    prog = program_readings(args.seeds, "program_s_per_seed")
    refs = {}
    for s in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)):
        t = time.perf_counter()
        refs[s] = train.reference_readings(config, mix, s, device, n)
        timings.setdefault("reference_s", []).append(time.perf_counter() - t)

    def add(kind, s, readings):
        report["runs"].setdefault(kind, {})[str(s)] = summary(readings, refs[s])
        print(f"[calibrate] {kind} {s} " + json.dumps(
            {k: v for k, v in report["runs"][kind][str(s)].items()
             if not k.startswith("top")}),
            flush=True)

    for s in args.seeds:
        add("program", s, prog[s])
    for kind, seed_list, kw in (("control_fp8", args.control_seeds, {"precision": "fp8"}),
                                ("fault_half_batch", args.fault_seeds,
                                 {"keep_tokens": mix["seq"] // 2})):
        for s in seed_list:
            t = time.perf_counter()
            add(kind, s, train.reference_readings(config, mix, s, device, n, **kw))
            timings.setdefault(kind + "_s", []).append(time.perf_counter() - t)
    report["seconds"] = time.perf_counter() - T_START
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"[calibrate] timings {json.dumps(timings)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
