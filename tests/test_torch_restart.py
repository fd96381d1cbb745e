"""Restarts through the port's launcher (``repro_torch.launch.train.run``
inside ``runtime.resilient_loop``), reduced TinyLlama under AdamW, on the
CPU.

* A run whose fault injector raises before step 4 (after the checkpoint
  at step 3) equals the unbroken run bit for bit: every step's loss, the
  parameters, both AdamW moments, AdamW's step count and the EF residual;
  its replayed step 3 gives step 3's loss again.  f32 wire and
  ``bf16_ef``, ``post`` and ``dag``, at world 1 and on 2 gloo ranks (each
  rank's residual is its own: stored as ``(2, *shape)`` rows, each rank
  takes its row back).  Also a fault before any checkpoint (a restart
  from scratch), and one raised inside backward under ``dag`` with a
  group's all-reduce in flight.
* Under ``--autotune`` (``measure_units`` stubbed) and
  ``--comm-refit-every`` (the timed all-reduce replaced by a function of
  the step), the restart adopts the plan stored beside the checkpoint and
  resumes the tuner's history and the refitter's state: the next
  checkpoint's ``plan.json`` and ``tuner.json`` equal the unbroken run's.
* A checkpoint made on 2 ranks (f32 wire) restores at world 1 through
  ``checkpoint.restore_rebucketed`` with a plan built for N = 1, bit for
  bit the 2-rank run's state at that step.

Everything here is exact: no tolerance.
"""

import json
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _env import REPO_ROOT, SUBPROC_ENV
from _torch_env import bits, world1
from repro_torch.checkpoint import available_steps, load_tuner_state, restore_rebucketed
from repro_torch.configs import get_reduced
from repro_torch.core.comm_model import AllReduceModel
from repro_torch.core.sync import GradientSync, SyncConfig
from repro_torch.core.trainer import MGWFBPEngine, batch_to_device
from repro_torch.data import DataConfig, make_stream
from repro_torch.fabric.ops import issue
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import run
from repro_torch.models import Transformer, param_shapes
from repro_torch.optim import make_optimizer
from repro_torch.runtime import RunState

BASE = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "2", "--seq", "32",
        "--fuse", "arena", "--device", "cpu", "--steps", "5"]
UNITS = ["embed", "stage_0", "stage_1", "stage_2", "stage_3", "head"]


def _fault_before(step):
    fired = []

    def inject(s):
        if s == step and not fired:
            fired.append(s)
            raise RuntimeError(f"injected fault before step {s}")

    return inject


def _state_bits(state: RunState) -> dict:
    out = {f"params/{n}": bits(t) for n, t in state.params.items()}
    out.update({f"m/{n}": bits(t) for n, t in state.opt_state.m.items()})
    out.update({f"v/{n}": bits(t) for n, t in state.opt_state.v.items()})
    out.update({f"residual/{n}": bits(t) for n, t in (state.residual or {}).items()})
    out["opt_step"] = state.opt_state.step
    return out


def _assert_same_state(a: RunState, b: RunState):
    sa, sb = _state_bits(a), _state_bits(b)
    assert sa.keys() == sb.keys()
    for k, v in sa.items():
        assert np.array_equal(v, sb[k]), k


def _ckpt(tmp_path, tag, every):
    return ["--ckpt-dir", str(tmp_path / tag), "--ckpt-every", str(every)]


@pytest.mark.parametrize("issue_order", ["post", "dag"])
@pytest.mark.parametrize("comp", ["f32", "bf16_ef"])
def test_restart_is_bitwise_the_unbroken_run(issue_order, comp, tmp_path):
    world1()
    args = BASE + ["--issue-order", issue_order] + (
        ["--compression", "bf16_ef"] if comp == "bf16_ef" else [])
    plain = run(args + _ckpt(tmp_path, "plain", 100), quiet=True)
    broken = run(args + _ckpt(tmp_path, "broken", 3) + ["--max-restarts", "1"], quiet=True,
                 fault_injector=_fault_before(4))
    assert (plain.restarts, broken.restarts) == (0, 1)
    assert plain.checkpoint_steps == [] and available_steps(tmp_path / "plain") == []
    assert broken.checkpoint_steps == [3] == available_steps(tmp_path / "broken")
    assert [r["op"] for r in broken.checkpoint_records] == ["save", "restore"]
    assert broken.step_indices == [0, 1, 2, 3, 3, 4]
    assert len(plain.losses) == len(broken.losses) == 5
    assert broken.losses == plain.losses
    assert broken.replayed_losses == [(3, plain.losses[3])]
    _assert_same_state(broken.state, plain.state)
    assert broken.state.opt_state.step == 5 and (broken.state.residual is None) == (comp == "f32")
    assert [d.get("issue", 0) for d in broken.step_launches] == broken.step_groups


def test_restart_from_scratch_resets_the_live_state(tmp_path):
    """A fault before the first checkpoint: the weights are drawn from the
    seed again and AdamW's state and the residual zeroed, in place."""
    world1()
    args = BASE + ["--issue-order", "dag", "--compression", "bf16_ef"]
    plain = run(args + _ckpt(tmp_path, "plain", 100), quiet=True)
    broken = run(args + _ckpt(tmp_path, "broken", 3) + ["--max-restarts", "1"], quiet=True,
                 fault_injector=_fault_before(2))
    assert broken.restarts == 1 and broken.step_indices == [0, 1, 0, 1, 2, 3, 4]
    assert broken.losses == plain.losses
    assert broken.replayed_losses == [(0, plain.losses[0]), (1, plain.losses[1])]
    _assert_same_state(broken.state, plain.state)


def test_fault_inside_backward_with_a_group_in_flight(tmp_path, monkeypatch):
    """The third group of step 4 raises as it is packed, inside backward,
    with two groups' all-reduces issued: the step waits for them, the
    loop restores step 3, and the run still equals the unbroken one."""
    world1()
    args = BASE + ["--issue-order", "dag", "--compression", "bf16_ef", "--policy", "wfbp"]
    plain = run(args + _ckpt(tmp_path, "plain", 100), quiet=True)
    armed = {"on": False, "fired": False, "groups": 0, "waited": []}
    real = GradientSync.start_group

    class Work:  # the in-flight all-reduce, which must be waited for
        def __init__(self, work):
            self.work, self.i = work, len(armed["waited"])
            armed["waited"].append(False)

        def wait(self):
            armed["waited"][self.i] = True
            return self.work.wait()

    def start_group(self, gi, *a, **kw):
        if armed["on"]:
            armed["groups"] += 1
            if armed["groups"] == 3:
                armed.update(on=False, fired=True)
                raise RuntimeError("injected fault inside backward")
            pending = real(self, gi, *a, **kw)
            pending.work = Work(pending.work)
            return pending
        return real(self, gi, *a, **kw)

    def arm(step):  # the injector raises nothing: it arms step 4's first run
        armed["on"] = step == 4 and not armed["fired"]

    monkeypatch.setattr(GradientSync, "start_group", start_group)
    broken = run(args + _ckpt(tmp_path, "broken", 3) + ["--max-restarts", "1"], quiet=True,
                 fault_injector=arm)
    assert broken.engine.sync.n_groups == 6 and broken.restarts == 1 and armed["fired"]
    assert armed["waited"] == [True, True]
    assert broken.step_indices == [0, 1, 2, 3, 3, 4]
    assert broken.losses == plain.losses
    _assert_same_state(broken.state, plain.state)


def test_restart_resumes_plan_tuner_and_refitter(tmp_path, monkeypatch, capsys):
    """Startup adopts 1 group; the comm re-fits at steps 2, 4 and 6 re-sweep
    under a drifting (α, β) that is a function of the step.  The restart at
    step 5 adopts step 3's stored plan and resumes the stored history and
    refitter: the checkpoint at step 6 is the unbroken run's, plan and tuner
    state alike."""
    world1()
    now = {"step": -1}

    def injector(fault):
        fired = []

        def inject(step):
            now["step"] = step
            if step == fault and not fired:
                fired.append(step)
                raise RuntimeError(f"injected fault before step {step}")

        return inject

    def fake_psum_time_fn(*args, **kwargs):
        # a cheap wire, then an expensive one: the sweeps pick other plans
        return lambda nbytes: 1e-6 + nbytes * (1e-12 if now["step"] < 4 else 1e-7) \
            + 1e-3 * (now["step"] >= 4)

    monkeypatch.setattr(train_mod, "psum_time_fn", fake_psum_time_fn)
    args = BASE + ["--issue-order", "dag", "--compression", "bf16_ef", "--steps", "8",
                   "--autotune", "--replan-every", "0", "--comm-refit-every", "2"]
    plain = run(args + _ckpt(tmp_path, "plain", 3), quiet=True,
                measure_units=lambda: {u: 1e-7 for u in UNITS}, fault_injector=injector(None))
    now["step"] = -1
    capsys.readouterr()
    broken = run(args + _ckpt(tmp_path, "broken", 3) + ["--max-restarts", "1"],
                 measure_units=lambda: {u: 1e-7 for u in UNITS}, fault_injector=injector(5))
    out = capsys.readouterr().out
    assert broken.restarts == 1 and "[train] restart at step 3: restored plan" in out
    assert broken.losses == plain.losses
    by_step = dict(zip(plain.step_indices, plain.step_groups))
    assert [by_step[s] for s in broken.step_indices] == broken.step_groups
    assert len(set(plain.step_groups)) > 1  # the stored plan is not the startup one
    assert available_steps(tmp_path / "plain") == available_steps(tmp_path / "broken") == [3, 6]
    for name in ("plan.json", "tuner.json"):
        want = json.loads((tmp_path / "plain" / "step_00000006" / name).read_text())
        got = json.loads((tmp_path / "broken" / "step_00000006" / name).read_text())
        assert got == want, name
    state = load_tuner_state(tmp_path / "broken", 6)
    assert state["comm_refitter"]["checks"] == 2  # steps 2 and 4
    assert [r["trigger"] for r in state["history"]] == \
        [r.trigger for r in plain.tuner_history][:len(state["history"])]
    _assert_same_state(broken.state, plain.state)


RANKS_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from repro_torch.launch.train import run

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    base = json.loads(sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)

    def fault_before(step):
        fired = []
        def inject(s):
            if s == step and not fired:
                fired.append(s)
                raise RuntimeError("injected fault")
        return inject

    def state(res):
        s = res.state
        return {"params": {n: t.detach().clone() for n, t in s.params.items()},
                "m": s.opt_state.m, "v": s.opt_state.v, "step": s.opt_state.step,
                "residual": s.residual}

    result = {}
    for tag, extra in (("f32_post", ["--issue-order", "post"]),
                       ("ef_dag", ["--issue-order", "dag", "--compression", "bf16_ef"])):
        args = base + extra
        plain = run(args + ["--ckpt-dir", f"{out}/{tag}_plain", "--ckpt-every", "100"],
                    quiet=True)
        broken = run(args + ["--ckpt-dir", f"{out}/{tag}_broken", "--ckpt-every", "3",
                             "--max-restarts", "1"], quiet=True, fault_injector=fault_before(4))
        torch.save({"plain": state(plain), "broken": state(broken)}, f"{out}/{tag}_{rank}.pt")
        result[tag] = {"plain": plain.losses, "broken": broken.losses,
                       "replayed": broken.replayed_losses, "restarts": broken.restarts,
                       "steps": broken.checkpoint_steps, "indices": broken.step_indices}
    # the state at step 3, for the restore at world 1
    three = run(base + ["--issue-order", "post", "--steps", "3", "--ckpt-dir",
                        f"{out}/three", "--ckpt-every", "100"], quiet=True)
    torch.save(state(three), f"{out}/three_{rank}.pt")
    dist.destroy_process_group()
    print(json.dumps(result))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_ranks")
    base = BASE + ["--batch", "4"]
    port = _free_port()
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANKS_SCRIPT, str(r), str(port), str(out),
                               json.dumps(base)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=REPO_ROOT)
             for r in range(2)]
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-3000:]
            results.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out, results


def _flat_bits(st):
    out = {"step": st["step"]}
    for key in ("params", "m", "v", "residual"):
        for n, t in (st[key] or {}).items():
            out[f"{key}/{n}"] = bits(t)
    return out


@pytest.mark.parametrize("tag", ["f32_post", "ef_dag"])
def test_restart_on_two_gloo_ranks_is_bitwise_the_unbroken_run(tag, two_ranks):
    out, results = two_ranks
    r0, r1 = results[0][tag], results[1][tag]
    for key in ("plain", "broken", "replayed", "restarts", "indices"):
        assert r0[key] == r1[key], key  # the losses are the mean over both ranks
    assert r0["restarts"] == 1 and r0["indices"] == [0, 1, 2, 3, 3, 4]
    assert r0["broken"] == r0["plain"] and r0["replayed"] == [[3, r0["plain"][3]]]
    assert r0["steps"] == [3] and r1["steps"] == []  # only rank 0 writes
    assert available_steps(out / f"{tag}_broken") == [3]
    finals = []
    for rank in range(2):
        saved = torch.load(out / f"{tag}_{rank}.pt")
        plain, broken = _flat_bits(saved["plain"]), _flat_bits(saved["broken"])
        assert plain.keys() == broken.keys()
        for k, v in plain.items():
            assert np.array_equal(v, broken[k]) if k != "step" else v == broken[k], (rank, k)
        finals.append(saved["plain"])
    manifest = json.loads((out / f"{tag}_broken" / "step_00000003" / "manifest.json").read_text())
    shapes = {e["name"]: e["shape"] for e in manifest["entries"]}
    for n, t in finals[0]["params"].items():
        assert shapes[f"params/{n}"] == list(t.shape)
        if tag == "ef_dag":  # every rank's residual, one row each
            assert shapes[f"residual/{n}"] == [2, *t.shape]
    if tag == "ef_dag":  # the residuals are per-rank state: the ranks' differ
        assert any(not torch.equal(finals[0]["residual"][n], finals[1]["residual"][n])
                   for n in finals[0]["residual"])


def test_two_rank_checkpoint_restores_at_world1_rebucketed(two_ranks):
    """The 2-rank f32 checkpoint at step 3 into a world-1 model, with the
    schedule re-planned for N = 1; the state is the 2-rank run's at step 3
    bit for bit, and a step on it issues one all-reduce per group."""
    out, _ = two_ranks
    world1()
    cfg = get_reduced("tinyllama-1.1b", param_dtype=torch.float32)
    model = Transformer(cfg, device="cpu", seed=1)  # other weights, overwritten
    opt = make_optimizer("adamw")
    opt_state = opt.init(dict(model.named_parameters()))
    state = RunState(step=0, params=dict(model.named_parameters()), opt_state=opt_state)

    def schedule_fn():
        return MGWFBPEngine.build(cfg, param_shapes(cfg), ar_model=AllReduceModel(a=5e-5, b=1e-9),
                                  tokens_per_device=4 * 32, policy="mg_wfbp",
                                  sync_config=SyncConfig(fuse="arena"))

    tree, engine, extra = restore_rebucketed(out / "f32_post_broken", 3,
                                             state.checkpoint_tree(), schedule_fn)
    opt_state.step = tree["opt_state"]["step"]
    assert extra == {"restarts": 0} and opt_state.step == 3
    want = _flat_bits(torch.load(out / "three_0.pt"))
    got = _flat_bits({"params": state.params, "m": opt_state.m, "v": opt_state.v,
                      "step": opt_state.step, "residual": None})
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(v, got[k]) if k != "step" else v == got[k], k
    assert engine.plan.provenance.get("arch") == cfg.name
    step = engine.make_train_step(model, opt, issue="post", opt_state=opt_state)
    batch = batch_to_device(make_stream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                                   global_batch=4)).batch_at(3),
                            torch.device("cpu"))
    calls = issue.calls
    loss = float(step(batch)["loss"])
    assert np.isfinite(loss) and issue.calls == calls + engine.sync.n_groups
    assert opt_state.step == 4
