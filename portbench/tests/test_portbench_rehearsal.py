"""Each cell's driver end to end at its arch's reduced size on the CPU, as
a rehearsal of a chip run: the result line's keys, the comparison with
the plain reference, and the comparison failing when the timed path is
broken underneath (a step that leaves its state unchanged, half of each
batch left out) or when the reference in fp8 stands in for the program.
The measured command itself refuses the CPU; these tests call the
drivers directly.

    PYTHONPATH=src python -m pytest -q portbench/tests
"""

import argparse
import dataclasses
import pathlib
import sys
import time

import pytest
import torch

PB = pathlib.Path(__file__).resolve().parents[1]
ROOT = PB.parent
sys.path.insert(0, str(ROOT))

from portbench import bench, check  # noqa: E402
from portbench import run as command  # noqa: E402
from portbench.drivers import train  # noqa: E402

SEED = 2**31 + 4242
CPU = torch.device("cpu")
TRAIN_CELLS = [w["name"] for w in bench.benchmark(ROOT)["workloads"]
               if bench.cell(w["name"], ROOT).workload["driver"] == "train"]


def reduced(name: str, seq: int = 64, batch: int = 2):
    """The cell at its arch's reduced widths (the program's ``get_reduced``,
    with the file's overrides), with short batches: ``(cell, arch)``."""
    cell = bench.cell(name, ROOT)
    arch = train.program_config(cell.config, reduced=True)
    a = arch.attention
    cfg = dict(cell.config, n_layers=arch.n_layers, d_model=arch.d_model, d_ff=arch.d_ff,
               vocab=arch.vocab, n_heads=a.n_heads, n_kv_heads=a.n_kv_heads,
               head_dim=a.head_dim,
               embed_scale=arch.d_model ** 0.5 if arch.tie_embeddings else 1.0)
    mix = dict(cell.traffic, seq=seq, batch=batch, distinct_batches=4)
    return dataclasses.replace(cell, config=cfg, traffic=mix), arch


def rehearse(name: str, trace: bool = False):
    cell, arch = reduced(name)
    res = bench.driver(cell.workload["driver"]).run(cell, SEED, 0.3, trace, CPU,
                                                    time.perf_counter(), arch=arch)
    info = {"platform": "cpu", "kind": "rehearsal", "count": 1, "memory_peak_bytes": 0}
    if trace:
        info.update(busy_s=res["window"].busy_s, window_s=res["window"].wall_s)
    args = argparse.Namespace(trace=int(trace))
    return command.result_line(cell, args, res, info)


@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_training_cell_rehearsal(name, trace):
    out, correct = rehearse(name, trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks" and correct and out["failed"] == 0
    if not trace:
        assert set(out["metrics"]) == {"train_tok_s", "setup_s"}
    else:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_a_step_that_leaves_its_state_unchanged_fails(name, monkeypatch):
    import repro_torch.optim.optimizers as opt

    def unchanged(grads, state, params, lr, **kw):
        state.step += 1
        return state

    monkeypatch.setattr(opt, "adamw_update", unchanged)
    out, correct = rehearse(name)
    change = [c["value"] for k, c in out["checks"].items() if k.startswith("change_gap")]
    assert not correct and change == [pytest.approx(1.0)]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_half_of_each_batch_left_out_fails(name, monkeypatch):
    from repro_torch.models.transformer import Transformer

    loss = Transformer.loss

    def half(self, batch, **kw):
        keep = batch["tokens"].shape[1] // 2
        return loss(self, {k: v[:, :keep] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(Transformer, "loss", half)
    _, correct = rehearse(name)
    assert not correct


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_the_fp8_control_fails(name):
    """The reference with fp8 products in the program's place reads past
    at least one limit, where the program does not."""
    cell, _ = reduced(name)
    ref = train.reference_readings(cell.config, cell.traffic, SEED, CPU, 3)
    control = train.reference_readings(cell.config, cell.traffic, SEED, CPU, 3, precision="fp8")
    correct, checks = check.verdict(check.train_numbers(control, ref), cell.workload["limits"])
    assert not correct, checks

