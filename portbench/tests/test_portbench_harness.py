"""The harness's files and contract, checked from the files alone (CPU).

    PYTHONPATH=src python -m pytest -q portbench/tests
"""

import ast
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

PB = pathlib.Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def imported_tops(path: pathlib.Path) -> set[str]:
    """Top-level names of every module a source file imports (relative
    imports stay inside the package)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def sources(folder: pathlib.Path) -> list[pathlib.Path]:
    return sorted(p for p in folder.rglob("*.py") if "__pycache__" not in p.parts)


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources(PB):
        bad = imported_tops(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(PB / "reference"):
        tops = imported_tops(path)
        assert "repro_torch" not in tops and not tops & FORBIDDEN, path
        assert tops <= {"__future__", "math", "torch"}, (path, tops)


def test_every_cell_finds_its_files():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        wl = json.loads((PB / "workloads" / f"{w['name']}.json").read_text())
        assert (PB / "drivers" / f"{wl['driver']}.py").exists()
        assert (ROOT / configs[w["config"]]["file"]).exists()
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
        assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())
    for path in (PB / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        assert (PB / "drivers" / f"{wl['driver']}.py").exists(), path


def test_every_per_layer_metric_has_a_reader_and_reported_moves():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert m["moves"] in e2e
        listed = m.get("workloads", sorted(cells))
        assert set(listed) <= cells
        for c in listed:
            assert c in e2e[m["moves"]].get("workloads", [c]), (m["name"], c)
    for c in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        names = [m["name"] for m in b["end_to_end"] if c in m.get("workloads", [c])]
        assert "setup_s" in names and len(names) >= 2
        assert any(c in m.get("workloads", [c]) for m in b["per_layer"])


def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
               and ".." not in p for p in b["paths"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"] == f"portbench/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    seen = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


def test_a_cell_a_config_and_a_metric_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a cell, a configuration and a per-layer
    metric by new files and new entries; no file of the harness changes."""
    sys.path.insert(0, str(ROOT))
    from portbench import bench as harness

    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    digest = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (root / "portbench").rglob("*") if p.is_file()}
    b = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/starcoder2_3b.json").read_text())
    cfg.update(name="starcoder2_3b_l10", n_layers=10, reduced=["n_layers"],
               program_overrides={**cfg["program_overrides"], "n_layers": 10})
    (root / "portbench/configs/starcoder2_3b_l10.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/train_2k.json").write_text(json.dumps(
        {"kind": "lm_batches", "batch": 2, "seq": 2048, "distinct_batches": 8}))
    (root / "portbench/workloads/sc2_3b_l10.train_2k.json").write_text(
        (root / "portbench/workloads/sc2_3b.train_4k.json").read_text())
    (root / "portbench/metrics/steps.train.py").write_text(
        "def read(window, ctx):\n    return float(window.steps)\n")
    b["configs"].append({"name": "starcoder2_3b_l10", "source": cfg["source"],
                         "file": "portbench/configs/starcoder2_3b_l10.json",
                         "reduced": ["n_layers"], "why": "a test"})
    b["workloads"].append({"name": "sc2_3b_l10.train_2k", "config": "starcoder2_3b_l10",
                           "traffic": "train_2k", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                           "source": "device_trace", "layer": "train step",
                           "moves": "train_tok_s", "workloads": ["sc2_3b_l10.train_2k"]})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("sc2_3b_l10.train_2k")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = harness.cell("sc2_3b_l10.train_2k", root, here=root / "portbench")
    assert cell.config["n_layers"] == 10 and cell.traffic["seq"] == 2048
    assert [m["name"] for m in cell.per_layer] == ["steps.train"]
    assert harness.driver(cell.workload["driver"], here=root / "portbench").run
    read = harness.metric_reader("steps.train", here=root / "portbench")
    assert read(type("W", (), {"steps": 3})(), {}) == 3.0
    old = harness.cell("sc2_3b.train_4k", root, here=root / "portbench")
    assert "steps.train" not in [m["name"] for m in old.per_layer]
    for p, h in digest.items():
        assert hashlib.sha256(p.read_bytes()).hexdigest() == h, p


def _run(args, cwd, env=None):
    env = dict(os.environ, **(env or {}))
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_chip_no_result():
    """Finding no CUDA device the command fails and prints no result; it
    never falls back to the CPU."""
    p = _run(["--workload", "sc2_3b.train_4k", "--seed", "3000000000", "--seconds", "1",
              "--trace", "0"], ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _run(["--workload", "sc2_3b.train_4k", "--seed", "7", "--seconds", "1", "--trace", "0"],
             tmp_path, {"PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**33 + 1])
def test_traffic_repeats_on_a_seed(seed):
    import torch

    from portbench import traffic

    mix = traffic.load("train_4k")
    small = dict(mix, seq=64, distinct_batches=3)
    a = traffic.lm_batches(small, 1000, seed, torch.device("cpu"))
    b = traffic.lm_batches(small, 1000, seed, torch.device("cpu"))
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) for x, y in zip(a, b))
    assert not torch.equal(a[0][0], a[1][0])  # the first steps see rows that differ
    assert torch.equal(a[0][0][:, 1:], a[0][1][:, :-1])  # targets are the next tokens


def test_the_trace_reduction():
    """Busy time is the union of kernel intervals; an idle gap goes to the
    runtime call that started last before it closed and the closing
    kernel's class."""
    from portbench.devtrace import Window

    kernels = [("nvjet_tst_gemm", 0.0, 10.0), ("vectorized_elementwise_kernel", 5.0, 12.0),
               ("flash_fwd_sm90_kernel", 20.0, 30.0), ("pack_kernel", 30.5, 40.0)]
    host = [("cudaLaunchKernel", 18.0, 19.0), ("cudaStreamSynchronize", 1.0, 2.0)]
    w = Window(kernels=kernels, host_ops=host, wall_s=50e-6, steps=1)
    assert w.busy_s == pytest.approx(31.5e-6)
    assert w.idle_gaps() == [["cudaLaunchKernel > flash_attention", pytest.approx(8e-6)]]
    assert w.seconds_where(("pack_kernel",)) == (pytest.approx(9.5e-6), 1)
