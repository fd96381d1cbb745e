"""The port's restart loop and straggler detection
(``repro_torch.runtime.fault_tolerance``) against the JAX package's
``repro.runtime.fault_tolerance``, on the same toy runs.

* ``StragglerMonitor``: the same decision on every step of seeded
  duration sequences (steady, with slow bursts, with a step change), at
  three settings.
* ``resilient_loop`` on a toy state (a weight, an optimizer step count and
  moment, a residual; each step adds to them), under the same fault
  schedules: the same ``train_step`` calls, ``on_restart`` calls, restart
  counts, ``sleep_fn`` arguments, checkpoint steps, saved ``extra``,
  ``plan.json`` / ``tuner.json`` texts and final values.  The port's state
  lives in tensors it updates in place; the JAX one's is rebuilt.
* A second loop on the same directory folds the saved restart count back
  in; ``KeyboardInterrupt`` passes through untouched; past
  ``max_restarts`` the fault is raised.

Everything here is exact: no tolerance.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.fault_tolerance import (
    RunState as JaxRunState,
    StragglerMonitor as JaxStragglerMonitor,
    resilient_loop as jax_resilient_loop,
)
from repro_torch.checkpoint import available_steps
from repro_torch.optim import OptState
from repro_torch.runtime import RunState, StragglerMonitor, resilient_loop


def _durations(kind, seed, n=120):
    rng = np.random.default_rng(seed)
    d = rng.lognormal(np.log(0.1), 0.05, n)
    if kind == "bursts":
        for start in rng.choice(n - 5, 8, replace=False):
            d[start:start + rng.integers(1, 5)] *= rng.uniform(1.5, 4.0)
    elif kind == "step":
        d[n // 2:] *= 3.0
    return [float(x) for x in d]


@pytest.mark.parametrize("kind", ["steady", "bursts", "step"])
@pytest.mark.parametrize("settings", [{}, {"factor": 1.5, "patience": 2, "window": 8},
                                      {"factor": 3.0, "patience": 1, "window": 64}],
                         ids=["defaults", "tight", "loose"])
def test_straggler_monitor_matches_reference(kind, settings):
    for seed in range(3):
        durations = _durations(kind, seed)
        mine, ref = StragglerMonitor(**settings), JaxStragglerMonitor(**settings)
        assert [mine.observe(d) for d in durations] == [ref.observe(d) for d in durations]
        assert (mine.remediations, mine.consecutive_slow, mine.durations) == \
            (ref.remediations, ref.consecutive_slow, ref.durations)
    if kind == "bursts" and not settings:
        assert ref.remediations > 0  # the case exercises remediation


def _injector(schedule, exc=RuntimeError):
    left = dict(schedule)

    def inject(step):
        if left.get(step, 0) > 0:
            left[step] -= 1
            raise exc(f"injected fault before step {step}")

    return inject


def _port_loop(ckpt_dir, schedule, *, steps=10, every=3, max_restarts=5, exc=RuntimeError,
               log=None):
    """The toy run in the port: the state lives in tensors updated in place."""
    log = {} if log is None else log
    log.update(calls=[], restarts_seen=[], sleeps=[])
    live, res = {"w": torch.zeros(4)}, {"w": torch.zeros(4)}
    opt = OptState(step=0, m={"w": torch.zeros(4)}, v={})

    def init_state():
        for t in (live["w"], opt.m["w"], res["w"]):
            t.zero_()
        opt.step = 0
        return RunState(step=0, params=live, opt_state=opt, residual=res)

    def train_step(state, step):
        log["calls"].append(step)
        state.params["w"].add_(step + 1)
        state.opt_state.step += 1
        state.opt_state.m["w"].add_(0.5)
        state.residual["w"].add_(0.25)
        return state

    def on_restart(state):
        log["restarts_seen"].append((state.step, state.restarts))
        return state

    final = resilient_loop(
        num_steps=steps, init_state=init_state, train_step=train_step,
        checkpoint_dir=str(ckpt_dir), checkpoint_every=every, max_restarts=max_restarts,
        sleep_fn=log["sleeps"].append, fault_injector=_injector(schedule, exc),
        on_restart=on_restart,
        plan_provider=lambda: {"calls_so_far": len(log["calls"])},
        tuner_provider=lambda: {"format": 1, "history": list(log["calls"])},
    )
    log["final"] = (final.step, final.restarts, live["w"].tolist(), opt.step,
                    opt.m["w"].tolist(), res["w"].tolist())
    return log


def _jax_loop(ckpt_dir, schedule, *, steps=10, every=3, max_restarts=5, exc=RuntimeError,
              log=None):
    """The same toy run in the JAX package, on immutable arrays."""
    log = {} if log is None else log
    log.update(calls=[], restarts_seen=[], sleeps=[])

    def init_state():
        return JaxRunState(step=0, params={"w": jnp.zeros(4, jnp.float32)},
                           opt_state={"step": jnp.zeros((), jnp.int32),
                                      "m": jnp.zeros(4, jnp.float32)},
                           residual={"w": jnp.zeros(4, jnp.float32)})

    def train_step(state, step):
        log["calls"].append(step)
        return JaxRunState(step=state.step, params={"w": state.params["w"] + (step + 1)},
                           opt_state={"step": state.opt_state["step"] + 1,
                                      "m": state.opt_state["m"] + 0.5},
                           restarts=state.restarts, residual={"w": state.residual["w"] + 0.25})

    def on_restart(state):
        log["restarts_seen"].append((state.step, state.restarts))
        return state

    final = jax_resilient_loop(
        num_steps=steps, init_state=init_state, train_step=train_step,
        checkpoint_dir=str(ckpt_dir), checkpoint_every=every, max_restarts=max_restarts,
        sleep_fn=log["sleeps"].append, fault_injector=_injector(schedule, exc),
        on_restart=on_restart,
        plan_provider=lambda: {"calls_so_far": len(log["calls"])},
        tuner_provider=lambda: {"format": 1, "history": list(log["calls"])},
    )
    log["final"] = (final.step, final.restarts, np.asarray(final.params["w"]).tolist(),
                    int(final.opt_state["step"]), np.asarray(final.opt_state["m"]).tolist(),
                    np.asarray(final.residual["w"]).tolist())
    return log


def _saved(ckpt_dir):
    """Per complete checkpoint: its step, saved extra, plan.json and
    tuner.json texts."""
    out = []
    for step in available_steps(ckpt_dir):
        d = ckpt_dir / f"step_{step:08d}"
        out.append((step, json.loads((d / "manifest.json").read_text())["extra"],
                    (d / "plan.json").read_text(), (d / "tuner.json").read_text()))
    return out


SCHEDULES = {
    "none": {},
    "once": {4: 1},
    "before-any-checkpoint": {0: 1},
    "twice-at-one-step": {4: 2},
    "three-steps": {2: 1, 5: 1, 7: 1},
    "at-a-checkpoint-step": {6: 1, 9: 1},
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_resilient_loop_matches_reference(name, tmp_path):
    port = _port_loop(tmp_path / "port", SCHEDULES[name])
    ref = _jax_loop(tmp_path / "jax", SCHEDULES[name])
    for key in ("calls", "restarts_seen", "sleeps", "final"):
        assert port[key] == ref[key], key
    assert _saved(tmp_path / "port") == _saved(tmp_path / "jax")
    assert [s for s, *_ in _saved(tmp_path / "port")] == [3, 6, 9]
    assert port["final"][1] == sum(SCHEDULES[name].values())


def test_restart_count_survives_a_new_process(tmp_path):
    """A second loop on the same directory (a new process after a crash)
    restores the latest checkpoint and folds its saved count back in."""
    logs = {}
    for tag, loop in (("port", _port_loop), ("jax", _jax_loop)):
        d = tmp_path / tag
        first = loop(d, {2: 1, 5: 1}, steps=9)  # checkpoints at 3, 6, 9 carry restarts 1, 2, 2
        second = loop(d, {0: 1}, steps=12)  # restores step 9: 2 + 1 restarts
        logs[tag] = (first, second, _saved(d))
    (pf, ps, psaved), (jf, js, jsaved) = logs["port"], logs["jax"]
    assert pf == jf and ps == js and psaved == jsaved
    assert ps["restarts_seen"] == [(9, 3)] and ps["final"][:2] == (12, 3)
    assert ps["calls"] == [9, 10, 11]


def test_keyboard_interrupt_passes_through(tmp_path):
    for loop in (_port_loop, _jax_loop):
        with pytest.raises(KeyboardInterrupt):
            loop(tmp_path / loop.__name__, {2: 1}, exc=KeyboardInterrupt)
    # nothing retried: no checkpoint was read back, no backoff
    assert available_steps(tmp_path / "_port_loop") == []


def test_max_restarts_exceeded_raises(tmp_path):
    """Two restarts are allowed; the third fault is raised, after the same
    calls and backoffs in both packages."""
    logs = {}
    for tag, loop in (("port", _port_loop), ("jax", _jax_loop)):
        logs[tag] = {}
        with pytest.raises(RuntimeError, match="injected fault before step 7"):
            loop(tmp_path / tag, {1: 1, 4: 1, 7: 1}, max_restarts=2, log=logs[tag])
    assert logs["port"] == logs["jax"]
    assert logs["port"]["sleeps"] == [0.05, 0.1]
    assert logs["port"]["restarts_seen"] == [(0, 1), (3, 2)]
