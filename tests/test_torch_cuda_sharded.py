"""Sharded serving on the card: the plan-driven TP decode step on a one-rank
NCCL group.

On reduced TinyLlama (f32) under an ``mg_wfbp`` and a ``wfbp`` serve plan
(``gpu_nccl`` over ``{"model": 8}``), a ``ServingEngine`` with a
``("model",)`` ``DeviceMesh``:

* the captured step (its all-gathers inside the one CUDA graph) gives the
  eager sharded step's tokens and the unsharded engine's, for every
  request of a stream with joins, retirements and slot reuse;
* the engine holds one capture, and the capture's warm-up and recording
  each issue the plan's groups through ``issue()`` while the replays issue
  nothing from Python; the eager step issues the groups every step;
* ``install_plan`` to the other plan captures once more, and the tokens
  stay equal.

These tests need an NVIDIA GPU: they carry the ``cuda`` marker and skip
elsewhere.  The file imports no JAX:
``python -m pytest -q -m cuda tests/test_torch_cuda_sharded.py``.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from _torch_env import require_cuda
from repro_torch.configs import get_reduced
from repro_torch.fabric.ops import issue
from repro_torch.models import Transformer, param_shapes
from repro_torch.planning import build_serve_plan
from repro_torch.serving import Request, ServingEngine

ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def mesh():
    """A one-rank NCCL world on a FileStore (unless one exists) and its
    ``("model",)`` mesh; tears down only what it made."""
    require_cuda()
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    tmp = None
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="repro_torch_cuda_sharded_pg_")
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
    yield make_mesh((1,), ("model",), device_type="cuda")
    if tmp is not None:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _setup():
    cfg = get_reduced(ARCH, param_dtype=torch.float32)
    model = Transformer(cfg, device="cuda", seed=0)
    return cfg, model


def _plan(cfg, policy):
    return build_serve_plan(cfg, param_shapes(cfg), "gpu_nccl", {"model": 8}, batch_rows=2,
                            policy=policy, cache_dtype_bytes=4, act_dtype_bytes=4)


def _submit(eng, vocab, rid0=0):
    rng = np.random.default_rng(0)
    for rid in range(5):
        eng.submit(Request(rid=rid0 + rid,
                           prompt=rng.integers(0, vocab, size=int(rng.choice([9, 17, 40])),
                                               dtype=np.int32),
                           max_new_tokens=int(rng.integers(3, 9))))


def _tokens(eng, rid0=0):
    return {r.rid - rid0: r.generated for r in eng.completed if r.rid >= rid0}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["mg_wfbp", "wfbp"])
def test_cuda_sharded_captured_equals_eager_and_unsharded(policy, mesh):
    cfg, model = _setup()
    plan = _plan(cfg, policy)
    groups = len(plan.schedule.groups)
    ref = ServingEngine(cfg, model, slots=2, max_seq=64, plan=plan, cuda_graph=True)
    _submit(ref, cfg.vocab)
    ref.run_to_completion()
    out = {}
    for graph in (True, False):
        eng = ServingEngine(cfg, model, slots=2, max_seq=64, plan=plan, mesh=mesh,
                            cuda_graph=graph)
        issue.calls = 0
        eng.warmup()
        warm = issue.calls
        _submit(eng, cfg.vocab)
        eng.run_to_completion()
        out[graph] = (_tokens(eng), warm, issue.calls - warm, eng)
    tokens, warm, run_calls, eng = out[True]
    assert tokens == out[False][0] == _tokens(ref)
    assert eng.graph_captures == 1 and eng.compile_stats()["decode"] == 1
    assert warm == 2 * groups and run_calls == 0  # the warm-up run and the recording
    e_tokens, e_warm, e_calls, e_eng = out[False]
    assert e_warm == groups and e_calls == groups * (e_eng.decode_launches - 1)


@pytest.mark.cuda
def test_cuda_sharded_install_plan_captures_once_more(mesh):
    cfg, model = _setup()
    mg, wf = _plan(cfg, "mg_wfbp"), _plan(cfg, "wfbp")
    # two rounds of the same requests on one engine: the shared kpos row carries over
    # between them, so each round is held to the unsharded engine's same round
    ref = ServingEngine(cfg, model, slots=2, max_seq=64, cuda_graph=True)
    eng = ServingEngine(cfg, model, slots=2, max_seq=64, plan=mg, mesh=mesh, cuda_graph=True)
    for e in (ref, eng):
        _submit(e, cfg.vocab)
        e.run_to_completion()
    assert _tokens(eng) == _tokens(ref) and eng.graph_captures == 1
    eng.install_plan(wf)
    issue.calls = 0
    for e in (ref, eng):
        _submit(e, cfg.vocab, rid0=100)
        e.run_to_completion()
    assert _tokens(eng, rid0=100) == _tokens(ref, rid0=100)
    assert eng.graph_captures == 2 and issue.calls == 2 * len(wf.schedule.groups)
