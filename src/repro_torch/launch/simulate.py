"""The fleet-scale what-if CLI (counterpart of ``repro/launch/simulate.py``):
replay the plan lifecycle over hypothetical clusters and print each
policy's scaling-efficiency curve.

    PYTHONPATH=src python -m repro_torch.launch.simulate \\
        --arch googlenet --batch 64 --fabric paper_10gbe \\
        --sweep-hosts 8,64,512 --policies synceasgd,wfbp,mg_wfbp \\
        --report-out /tmp/simreport.json

It runs on the host and touches no device, in this package as in the JAX
one, so it takes no ``--device``: the discrete-event simulator
(``repro_torch.sim``) re-plans each policy at every fleet size, prices
the merged all-reduces through the fabric registry and replays the
backward / comm overlap event by event.  ``--report-out`` freezes the
sweep into a byte-deterministic ``SimReport`` (``SimReport.best_policy``
reads it as a plan-selection input).  ``--calibrate`` first replays the
committed BENCH records (``benchmarks/results``) at their small geometry
and refuses to extrapolate when the simulator is out of budget.

The CNN archs (googlenet / resnet50, the paper's workloads) price on the
K80-calibrated hardware model, the LM archs on the TPU analytic model at
16-way model sharding: the JAX CLI's choices, so both print the same
table.  Measured unit costs (``planning.MeasuredCosts``) go through the
``repro_torch.sim`` API instead.
"""

from __future__ import annotations

import argparse

from ..configs import ARCH_NAMES
from ..fabric import available_fabrics
from ..planning import available_policies
from ..sim import (
    ClusterSpec,
    SimReport,
    calibrate_serve,
    calibrate_train,
    replay_train,
    row_from_replay,
)

CNN_ARCHS = ("googlenet", "resnet50")


def sim_layer_costs(arch: str, batch: int, tokens_per_device: int = 8192):
    """(costs, hw) of one arch: the paper's CNN profiles on the calibrated
    K80, or an LM config's analytic unit costs on the TPU model."""
    if arch in CNN_ARCHS:
        from ..configs.cnn_profiles import cnn_layer_costs
        from ..core.cost_model import K80_CALIBRATED

        return cnn_layer_costs(arch, batch), K80_CALIBRATED
    from ..configs import get_config
    from ..core.cost_model import TPU_V5E
    from ..core.trainer import lm_unit_costs
    from ..models import param_shapes

    cfg = get_config(arch)
    return (
        lm_unit_costs(cfg, param_shapes(cfg),
                      tokens_per_device=tokens_per_device, model_shards=16),
        TPU_V5E,
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="what-if simulator: policies x fleets x fabrics")
    ap.add_argument("--arch", default="googlenet",
                    choices=list(CNN_ARCHS) + list(ARCH_NAMES),
                    help="workload: the paper's CNNs (K80-calibrated "
                         "hardware) or an LM config (TPU analytic model)")
    ap.add_argument("--batch", type=int, default=64,
                    help="per-host batch size (CNN archs; paper uses "
                         "googlenet 64 / resnet50 32)")
    ap.add_argument("--sweep-hosts", default="8,64,512",
                    help="comma-separated fleet sizes to simulate")
    ap.add_argument("--policies", default="synceasgd,wfbp,mg_wfbp",
                    help="comma-separated scheduler policies "
                         f"(available: {', '.join(available_policies())})")
    ap.add_argument("--fabric", default="paper_10gbe",
                    choices=available_fabrics(),
                    help="interconnect preset pricing the all-reduce: "
                         f"{', '.join(available_fabrics())}")
    ap.add_argument("--ici-size", type=int, default=0,
                    help="hosts per fast-tier domain (0 = one flat tier; "
                         "the remainder rides the cross-pod DCN axis)")
    ap.add_argument("--straggler-spread", type=float, default=0.0,
                    help="per-host compute multipliers drawn from "
                         "[1, 1+spread] (0 = homogeneous fleet)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the straggler draw (determinism contract: "
                         "identical seeds => byte-identical report)")
    ap.add_argument("--iters", type=int, default=1,
                    help="iterations replayed per cell (means reported)")
    ap.add_argument("--report-out", default=None,
                    help="write the frozen SimReport JSON here")
    ap.add_argument("--calibrate", action="store_true",
                    help="replay the committed BENCH records at the real "
                         "small-mesh geometry first; abort the what-if if "
                         "the error budget is blown")
    args = ap.parse_args(argv)

    hosts = [int(h) for h in args.sweep_hosts.split(",") if h.strip()]
    policies = [p.strip() for p in args.policies.split(",") if p.strip()]
    known = set(available_policies())
    for p in policies:
        if p not in known:
            ap.error(f"unknown policy {p!r}; available: {sorted(known)}")

    calibration = {}
    if args.calibrate:
        for rep in (calibrate_train(), calibrate_serve()):
            calibration[rep.kind] = rep.to_json_dict()
            print(f"[simulate] calibration/{rep.kind}: rows={len(rep.rows)} "
                  f"max_ratio={rep.max_ratio:.4f} budget={rep.budget} "
                  f"ok={rep.ok}")
            if not rep.ok:
                raise SystemExit(
                    f"calibration/{rep.kind} blew the {rep.budget}x budget "
                    f"(max ratio {rep.max_ratio:.4f}) — the what-if "
                    "extrapolation would not be trustworthy")

    costs, hw = sim_layer_costs(args.arch, args.batch)
    rows = []
    for n in hosts:
        cluster = ClusterSpec(
            n_hosts=n, ici_size=args.ici_size, fabric=args.fabric,
            straggler_spread=args.straggler_spread, seed=args.seed,
        )
        for policy in policies:
            res = replay_train(cluster, list(costs), policy,
                               hw=hw, n_iters=args.iters)
            rows.append(row_from_replay(res, args.arch, args.fabric, n))

    report = SimReport(
        rows=tuple(rows),
        calibration=calibration,
        provenance={
            "arch": args.arch,
            "batch": str(args.batch),
            "fabric": args.fabric,
            "seed": str(args.seed),
            "source": "launch/simulate",
        },
    )
    print(f"[simulate] arch={args.arch} fabric={args.fabric} "
          f"hosts={hosts} policies={policies}")
    for line in report.efficiency_table():
        print("  " + line)
    for n in hosts:
        print(f"[simulate] best policy at {n} hosts: "
              f"{report.best_policy(n_hosts=n)}")
    if args.report_out:
        path = report.save(args.report_out)
        print(f"[simulate] report written to {path}")


if __name__ == "__main__":
    main()
