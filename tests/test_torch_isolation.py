"""The port stands alone: every module of ``repro_torch`` imports with
``jax`` made unimportable and loads no ``repro`` module; the training CLI
runs the reduced model end to end on the CPU the same way; entry points
raise, rather than fall back, when CUDA is asked for and missing."""

import json
import subprocess
import sys
import textwrap

import pytest
import torch

from _env import REPO_ROOT, SUBPROC_ENV
from repro_torch import resolve_device

IMPORT_ALL = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    sys.modules["jax"] = None  # any import of jax now raises
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for n in names:
        importlib.import_module(n)
    loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
    print(json.dumps({"modules": names, "repro_loaded": loaded,
                      "jax_loaded": sys.modules.get("jax") is not None}))
""")

CLI_WITHOUT_JAX = textwrap.dedent("""
    import runpy, sys
    sys.modules["jax"] = None
    sys.argv = ["train"] + sys.argv[1:]
    runpy.run_module("repro_torch.launch.train", run_name="__main__")
    assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
""")


def test_every_module_imports_without_jax_or_repro():
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], capture_output=True, text=True,
        timeout=120, env=SUBPROC_ENV, cwd=REPO_ROOT,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["repro_loaded"] == [] and not rec["jax_loaded"]
    for mod in ("repro_torch.core.sync", "repro_torch.core.trainer",
                "repro_torch.kernels._build", "repro_torch.kernels.comm_pack.ops",
                "repro_torch.kernels.flash_attention.ops", "repro_torch.kernels.flash_attention.ref",
                "repro_torch.kernels.rglru.ops", "repro_torch.kernels.rglru.ref",
                "repro_torch.models.rglru", "repro_torch.configs.recurrentgemma_9b",
                "repro_torch.kernels.rwkv6_wkv.ops", "repro_torch.kernels.rwkv6_wkv.ref",
                "repro_torch.models.rwkv6", "repro_torch.configs.rwkv6_7b",
                "repro_torch.launch.train", "repro_torch.core.profiler",
                "repro_torch.planning.tuner", "repro_torch.fabric.measured",
                "repro_torch.runtime", "repro_torch.runtime.timeline",
                "repro_torch.checkpoint.checkpoint", "repro_torch.runtime.fault_tolerance",
                "repro_torch.runtime.compression", "repro_torch.launch.steps",
                "repro_torch.launch.serve", "repro_torch.planning.serve",
                "repro_torch.serving", "repro_torch.serving.engine",
                "repro_torch.serving.resilience", "repro_torch.serving.fleet",
                "repro_torch.launch.serve_fleet", "repro_torch.configs.musicgen_large",
                "repro_torch.configs.qwen2_vl_2b", "repro_torch.sim", "repro_torch.sim.events",
                "repro_torch.sim.cluster", "repro_torch.sim.replay", "repro_torch.sim.report",
                "repro_torch.sim.calibrate", "repro_torch.configs.cnn_profiles",
                "repro_torch.launch.simulate", "repro_torch.configs.shapes",
                "repro_torch.parallel", "repro_torch.parallel.sharding",
                "repro_torch.parallel.context", "repro_torch.launch.specs",
                "repro_torch.launch.segments", "repro_torch.launch.dryrun"):
        assert mod in rec["modules"]


def _cli(*args: str, arch: str = "tinyllama-1.1b") -> str:
    out = subprocess.run(
        [sys.executable, "-c", CLI_WITHOUT_JAX, "--arch", arch, "--reduced",
         "--device", "cpu", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
        env=dict(SUBPROC_ENV, OMP_NUM_THREADS="2"),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


SMALL = ["--batch", "2", "--seq", "64"]


@pytest.mark.parametrize("extra", [
    [],  # the launcher's defaults: batch 8 x seq 256, post, AdamW
    ["--issue-order", "dag", "--compression", "bf16_ef", *SMALL],
    ["--fuse", "concat", "--comm-dtype", "bf16", "--optimizer", "sgd", *SMALL],
    ["--attn-impl", "plain", *SMALL],
    ["--autotune", "--measure-comm", "--issue-order", "dag", "--comm-refit-every", "1", *SMALL],
], ids=["defaults", "dag-bf16_ef", "concat-bf16-sgd", "plain-attn", "autotune"])
def test_cli_smoke_on_cpu(extra):
    stdout = _cli("--steps", "2", "--fuse", "arena", *extra)
    assert "plan[mg_wfbp" in stdout
    assert f"attn={'plain' if '--attn-impl' in extra else 'flash'}" in stdout
    assert "[train] done: 2 steps" in stdout, stdout[-2000:]
    if "--autotune" in extra:
        assert "[train] measured comm fit" in stdout and "autotune startup sweep" in stdout


def test_cli_smoke_recurrentgemma_on_cpu():
    """The hybrid family through the same CLI: RG-LRU and local-attention
    sublayers, the tail and tied embeddings, with no JAX in the process."""
    stdout = _cli("--steps", "2", "--fuse", "arena", *SMALL, arch="recurrentgemma-9b")
    assert "plan[mg_wfbp" in stdout
    assert "[train] done: 2 steps" in stdout, stdout[-2000:]


def test_cli_smoke_rwkv6_on_cpu():
    """The RWKV6 family through the same CLI: the WKV recurrence, layernorm
    and the untied head, with no JAX in the process."""
    stdout = _cli("--steps", "2", "--fuse", "arena", *SMALL, arch="rwkv6-7b")
    assert "plan[mg_wfbp" in stdout and "attn=none" in stdout
    assert "[train] done: 2 steps" in stdout, stdout[-2000:]


def test_cli_plan_out_then_plan_in(tmp_path):
    plan = tmp_path / "plan.json"
    _cli("--steps", "1", "--fuse", "arena", "--policy", "wfbp", "--plan-out", str(plan), *SMALL)
    assert json.loads(plan.read_text())["provenance"]["policy"] == "wfbp"
    stdout = _cli("--steps", "1", "--fuse", "arena", "--plan-in", str(plan), *SMALL)
    assert "plan[wfbp" in stdout and "6 groups" in stdout


def test_cuda_is_required_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_model_defaults_to_cuda(monkeypatch):
    """The model is an entry point too: built without a device it asks
    for CUDA, and never lands on the CPU on its own."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import Transformer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("tinyllama-1.1b", param_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(cfg)
    assert Transformer(cfg, device="cpu", seed=0).embed.device.type == "cpu"


@pytest.mark.parametrize("modname", [
    "repro_torch.planning", "repro_torch.fabric", "repro_torch.core.sync",
    "repro_torch.kernels.comm_pack", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.rglru", "repro_torch.kernels.rwkv6_wkv", "repro_torch.kernels",
    "repro_torch.models", "repro_torch.optim", "repro_torch.runtime", "repro_torch.checkpoint",
    "repro_torch.serving", "repro_torch.sim",
])
def test_public_exports_have_docstrings(modname):
    """As the JAX package's docs-check: every exported class and function
    of the port's public modules says what it does."""
    import importlib
    import inspect

    mod = importlib.import_module(modname)
    assert mod.__doc__ and mod.__doc__.strip(), f"{modname} needs a module docstring"
    missing = [
        name for name in mod.__all__
        if (inspect.isclass(getattr(mod, name)) or inspect.isroutine(getattr(mod, name)))
        and not (inspect.getdoc(getattr(mod, name)) or "").strip()
    ]
    assert not missing, f"{modname} exports without docstrings: {missing}"
