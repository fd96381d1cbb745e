"""The serving engine on the card: the decode step as one CUDA graph.

* The captured step gives the eager step's tokens, for every request of a
  stream with joins, retirements and slot reuse, on reduced f32 configs
  of a dense, a hybrid and an attention-free arch; one graph is captured
  per engine and none after the first step.
* The kernel counters see each prefill and each decode step that ran in
  Python (the capture's warm-up and its recording), never a replay; the
  device trace shows every replay running the RG-LRU forward (B6) once per
  recurrent layer and no flash forward (B3); no plain version runs.
* ``probe_step_time`` replays the graph on the engine's own buffers and
  puts them back.

These tests need an NVIDIA GPU: they carry the ``cuda`` marker and skip
elsewhere.  The file imports no JAX:
``python -m pytest -q -m cuda tests/test_torch_cuda_serving.py``.
"""

import numpy as np
import pytest
import torch

from _torch_env import require_cuda
from repro_torch.configs import get_reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru as rg
from repro_torch.models import Transformer
from repro_torch.models.transformer import ATTN_KINDS, tree_leaves
from repro_torch.serving import Request, ServingEngine


def _stream(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, vocab, size=int(rng.choice([9, 17, 40])), dtype=np.int32),
             int(rng.integers(3, 9))) for rid in range(6)]


def _serve(cfg, model, cuda_graph):
    eng = ServingEngine(cfg, model, slots=2, max_seq=64, cuda_graph=cuda_graph)
    stream = _stream(cfg.vocab)
    for rid, prompt, n in stream[:3]:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    eng.step()
    for rid, prompt, n in stream[3:]:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    return eng, {r.rid: r.generated for r in eng.run_to_completion()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b", "rwkv6-7b"])
def test_cuda_graph_step_matches_eager(arch):
    device = require_cuda()
    cfg = get_reduced(arch, param_dtype=torch.float32)
    model = Transformer(cfg, device=device, seed=0)
    graph_eng, graph_tokens = _serve(cfg, model, True)
    eager_eng, eager_tokens = _serve(cfg, model, False)
    assert graph_tokens == eager_tokens and len(graph_tokens) == 6
    assert graph_eng.compile_stats()["graph_captures"] == 1
    assert eager_eng.compile_stats()["graph_captures"] == 0


@pytest.mark.cuda
def test_cuda_graph_replays_run_their_kernels():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    device = require_cuda()
    cfg = get_reduced("recurrentgemma-9b", param_dtype=torch.float32)
    model = Transformer(cfg, device=device, seed=0)
    kinds = cfg.block_kinds()
    attn, rec = sum(k in ATTN_KINDS for k in kinds), kinds.count("rec")
    fa.reset_counts()
    rg.reset_counts()
    eng, tokens = _serve(cfg, model, True)
    assert fa.flash_attention_fwd.launches == attn * len(tokens)
    in_python = eng.decode_launches - eng.graph_replays + eng.graph_captures
    assert eng.graph_captures == 1 and in_python == 2  # the warm-up and the recording
    assert rg.rglru_fwd.launches == rec * (len(tokens) + in_python)
    assert fa.flash_attention_fwd.ref_calls == rg.rglru_fwd.ref_calls == 0
    assert fa.flash_attention_dq.launches == rg.rglru_bwd.launches == 0
    launches = rg.rglru_fwd.launches
    # one warm-up step under the tracer, dropped; the device idle at both ends
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=3, repeat=1)) as prof:
        for i in range(4):
            eng._launch_step()
            if i in (0, 3):
                torch.cuda.synchronize()
            prof.step()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    # a decode step (T 1) runs B6's step kernel, never the tiled one
    assert sum("rglru_step_kernel" in n for n in names) == 3 * rec
    assert not any("flash_fwd" in n or "rglru_fwd_kernel" in n for n in names)
    assert rg.rglru_fwd.launches == launches and eng.graph_replays >= 4


@pytest.mark.cuda
def test_cuda_probe_restores_the_engine_state():
    device = require_cuda()
    cfg = get_reduced("tinyllama-1.1b", param_dtype=torch.float32)
    eng = ServingEngine(cfg, Transformer(cfg, device=device, seed=0), slots=2, max_seq=64)
    eng.submit(Request(rid=0, prompt=np.arange(8, dtype=np.int32), max_new_tokens=4))
    eng.step()
    before = [t.clone() for t in tree_leaves(eng._state)]
    assert eng.probe_step_time(repeats=3) > 0
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(eng._state)))
    assert eng.compile_stats()["graph_captures"] == 1
