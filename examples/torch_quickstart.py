"""Quickstart (the PyTorch port): compute MG-WFBP schedules and compare
them against WFBP / SyncEASGD / fixed-bucket baselines on the paper's
cluster model and on a TPU v5e pod.  No device is used: it is cost-model
arithmetic, and prints the same table as ``examples/quickstart.py``.

    python examples/torch_quickstart.py [--arch tinyllama-1.1b]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.cnn_profiles import cnn_layer_costs
from repro_torch.core.comm_model import paper_cluster_model
from repro_torch.core.cost_model import K80_CALIBRATED, TPU_V5E
from repro_torch.core.trainer import lm_unit_costs
from repro_torch.fabric.presets import tpu_psum_model
from repro_torch.models import param_shapes
from repro_torch.planning import build_schedule


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_NAMES)
    args = ap.parse_args()

    print("=== Paper setting: ResNet-50, 8-node 10GbE K80 cluster ===")
    costs = cnn_layer_costs("resnet50", 32)
    ar = paper_cluster_model(8)
    for method in ("wfbp", "synceasgd", "fixed", "mg_wfbp", "dp_optimal"):
        s = build_schedule(method, costs, ar, hw=K80_CALIBRATED)
        print(f"  {s.describe()}")

    print(f"\n=== {args.arch} on a 2x16x16 v5e multi-pod mesh (DP axes pod+data) ===")
    cfg = get_config(args.arch)
    lm_costs = lm_unit_costs(cfg, param_shapes(cfg), tokens_per_device=8192,
                             model_shards=16)
    ar = tpu_psum_model({"pod": 2, "data": 16})
    print(f"  units: {len(lm_costs)} (embed + {cfg.n_stages} stages"
          f"{' + tail' if cfg.tail_pattern else ''} + head)")
    print(f"  α = {ar.a * 1e6:.1f} µs, β = {ar.b * 1e9:.3f} ns/B")
    for method in ("wfbp", "synceasgd", "mg_wfbp", "dp_optimal"):
        s = build_schedule(method, lm_costs, ar, hw=TPU_V5E)
        print(f"  {s.describe()}")


if __name__ == "__main__":
    main()
