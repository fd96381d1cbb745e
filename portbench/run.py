"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Loads the cell's files (``bench.py``), sets
the program up from the seed, measures for ``--seconds`` (``--trace 0``:
the cell's end-to-end metrics) or traces a few steps (``--trace 1``: its
per-layer metrics), checks the output against the plain reference, and
prints one JSON object as the last line of standard output, with the
compared numbers beside their limits as the last lines of standard
error.  Without a CUDA device holding the cell's chips it prints no
result and exits with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and pathlib.Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)  # no module of this folder shadows a library's
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
NO_CHIP, JAX_LOADED = 3, 4


def loaded_forbidden() -> list[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, args, res: dict, device_info: dict) -> tuple[dict, bool]:
    """The result object (``checks`` last) and whether the output is correct."""
    from portbench import bench, check

    metrics = {}
    if args.trace:
        window, ctx = res["window"], res["ctx"]
        for m in cell.per_layer:
            v = bench.metric_reader(m["name"])(window, ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": res["measures"][m["name"]], "unit": m["unit"]}
    correct, checks = check.verdict(res["numbers"], cell.workload["limits"])
    correct &= res["failed"] == 0
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device_info}
    if args.trace:
        out["breakdown"] = {"device_ops": res["window"].device_ops(),
                            "idle_gaps": res["window"].idle_gaps()}
    out["checks"] = checks
    return out, correct


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from portbench import bench, check

    cell = bench.cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[portbench] {args.workload} needs {cell.chips} CUDA device(s); found {have}: "
              f"no result", file=sys.stderr)
        return NO_CHIP
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    drv = bench.driver(cell.workload["driver"])
    res = drv.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
            "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if args.trace:
        info["busy_s"] = res["window"].busy_s
        info["window_s"] = res["window"].wall_s
    out, correct = result_line(cell, args, res, info)
    bad = loaded_forbidden()
    if bad:
        print(f"[portbench] modules of JAX or the JAX package are loaded: {bad}; no result",
              file=sys.stderr)
        return JAX_LOADED
    for k, v in res["numbers"].items():
        print(f"[portbench] {k} {v}", file=sys.stderr)
    check.print_checks(out["checks"], correct)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
