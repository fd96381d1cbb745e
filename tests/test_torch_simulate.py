"""The what-if CLI of the port, ``python -m repro_torch.launch.simulate``,
against the JAX package's ``python -m repro.launch.simulate``: with the
same flags both print the same lines (calibration, the efficiency table,
the best policy per fleet size) and write the same ``SimReport`` bytes.
The port's CLI runs with ``jax`` made unimportable and loads no ``repro``
module; a calibration out of budget aborts the what-if."""

import subprocess
import sys
import textwrap

import pytest

from _env import REPO_ROOT, SUBPROC_ENV

PORT_CLI = textwrap.dedent("""
    import runpy, sys
    sys.modules["jax"] = None  # any import of jax now raises
    sys.argv = ["simulate"] + sys.argv[1:]
    runpy.run_module("repro_torch.launch.simulate", run_name="__main__")
    assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
""")


def _run(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
                         env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("flags", [
    ["--arch", "googlenet", "--sweep-hosts", "8,64", "--calibrate"],
    ["--arch", "tinyllama-1.1b", "--fabric", "gpu_nccl", "--sweep-hosts", "8,64,512",
     "--policies", "synceasgd,wfbp,mg_wfbp,dp_optimal"],
    ["--arch", "resnet50", "--batch", "32", "--fabric", "tpu_v5e_tree_dcn", "--ici-size", "16",
     "--sweep-hosts", "32,128", "--straggler-spread", "0.3", "--seed", "5", "--iters", "2"],
], ids=["googlenet-calibrate", "tinyllama-gpu_nccl", "resnet50-stragglers"])
def test_cli_prints_and_writes_what_the_jax_cli_does(tmp_path, flags):
    outs, reports = [], []
    for name, cmd in (("torch", [sys.executable, "-c", PORT_CLI]),
                      ("jax", [sys.executable, "-m", "repro.launch.simulate"])):
        path = tmp_path / f"{name}.json"
        stdout = _run(cmd + flags + ["--report-out", str(path)])
        outs.append(stdout.replace(str(path), "REPORT"))
        reports.append(path.read_bytes())
    assert outs[0] == outs[1]
    assert reports[0] == reports[1]
    assert "[simulate] best policy at" in outs[0]
    if "--calibrate" in flags:
        assert "calibration/train: rows=30" in outs[0] and "ok=True" in outs[0]
        from repro_torch.sim import SimReport

        rep = SimReport.load(tmp_path / "torch.json")
        assert rep.calibration["train"]["ok"] and rep.calibration["serve"]["ok"]
        assert {r.n_hosts for r in rep.rows} == {8, 64}


def test_calibration_out_of_budget_aborts(monkeypatch, capsys):
    from repro_torch.launch import simulate
    from repro_torch.sim import CalibrationReport, CalibrationRow

    blown = CalibrationReport(kind="serve", rows=(CalibrationRow("x", 1.0, 2.0),))
    monkeypatch.setattr(simulate, "calibrate_serve", lambda: blown)
    with pytest.raises(SystemExit, match="blew the 1.25x budget"):
        simulate.main(["--calibrate", "--sweep-hosts", "8"])
    assert "calibration/serve: rows=1 max_ratio=2.0000" in capsys.readouterr().out


def test_unknown_policy_is_refused(capsys):
    from repro_torch.launch import simulate

    with pytest.raises(SystemExit):
        simulate.main(["--policies", "wfbp,bogus"])
    assert "unknown policy 'bogus'" in capsys.readouterr().err
