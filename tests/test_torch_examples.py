"""The port's examples (``examples/torch_*.py``) on the CPU, each in its
own process with ``jax`` made unimportable and no ``repro`` module loaded:
the quickstart prints the JAX quickstart's table, the training example
learns, the serving example's sharded tokens equal its unsharded ones, and
the elastic example's resumed tokens equal the unbroken run's.  Asked for
``cuda`` without CUDA, each example that takes a device raises."""

import importlib.util
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from _env import REPO_ROOT, SUBPROC_ENV

EXAMPLES = REPO_ROOT / "examples"

WITHOUT_JAX = textwrap.dedent("""
    import runpy, sys
    sys.modules["jax"] = None  # any import of jax now raises
    path = sys.argv[1]
    sys.argv = [path] + sys.argv[2:]
    runpy.run_path(path, run_name="__main__")
    assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
""")


def _run(cmd: list[str], timeout: int = 300) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO_ROOT,
                         env=dict(SUBPROC_ENV, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _port(example: str, *args: str) -> str:
    return _run([sys.executable, "-c", WITHOUT_JAX, str(EXAMPLES / example), *args])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b"])
def test_quickstart_prints_the_jax_table(arch):
    got = _port("torch_quickstart.py", "--arch", arch)
    want = _run([sys.executable, str(EXAMPLES / "quickstart.py"), "--arch", arch])
    assert got == want
    assert "mg_wfbp:" in got and "dp_optimal:" in got


def test_train_lm_tiny_learns(tmp_path):
    out = _port("torch_train_lm.py", "--tiny", "--steps", "40", "--batch", "4", "--seq", "128",
                "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "20")
    first, final = map(float, re.search(r"loss: ([\d.]+) -> ([\d.]+) \(OK: learned\)",
                                        out).groups())
    assert final < 0.7 * first, out
    assert "through the packed arena" in out
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_00000020",
                                                                   "step_00000040"]


def test_train_lm_resumes_from_its_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    _port("torch_train_lm.py", "--tiny", "--steps", "4", "--batch", "2", "--seq", "64",
          "--device", "cpu", "--ckpt-dir", ck, "--ckpt-every", "2")
    out = _port("torch_train_lm.py", "--tiny", "--steps", "6", "--batch", "2", "--seq", "64",
                "--device", "cpu", "--ckpt-dir", ck, "--ckpt-every", "2")
    assert "resumed from checkpoint step 4" in out
    assert re.search(r"step +5 +loss", out) and not re.search(r"step +0 +loss", out)


def test_serve_decode_sharded_tokens_equal_unsharded():
    out = _port("torch_serve_decode.py", "--device", "cpu", "--tokens", "8")
    assert "tokens match unsharded run: True" in out
    assert "sharded TP=1" in out and "per-group predicted vs measured collective:" in out
    assert "pick different merge sets" in out  # tpu_v5e against gpu_nccl


def test_elastic_restart_resumes_token_identical(tmp_path):
    out = _port("torch_elastic_restart.py", "--device", "cpu",
                "--ckpt-dir", str(tmp_path / "ck"), "--snapshot-dir", str(tmp_path / "snap"))
    assert "phase 1 done: step=40 restarts=1" in out
    assert "schedule @ N=64:" in out and "5 more steps OK" in out
    assert "all 3 requests token-identical to the uninterrupted run" in out


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["torch_train_lm.py", "torch_serve_decode.py",
                                  "torch_elastic_restart.py"])
def test_cuda_is_required_unless_cpu_is_asked_for(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _load(name)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv)
