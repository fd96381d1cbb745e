"""Serving parity: the port's decode path and ``ServingEngine`` against the
JAX package's, on reduced configs with f32 weights bridged by
``from_jax_params``.

* ``make_prefill_step``'s last logits and caches, then 4
  ``make_decode_step`` logits, for each of the ten archs (token ids in
  both packages; the embeds archs read them through their tables): logits
  within 1e-4 x max|logit| (the model tests' gradient tolerance; XLA and
  ATen sum f32 in other orders), f32 cache leaves within 1e-4 x the
  leaf's max, and bf16 cache leaves (the prefill's k/v, as the JAX step
  stores them) within one bf16 rounding of the JAX element plus the f32
  leaves' 1e-4 x the leaf's max (the f32 values before the rounding differ
  by summation order).  The prompt
  is 64 tokens, the reduced configs' window: the JAX ring aligns there,
  and the decode steps wrap it.
* The JAX engine and the port's on one request stream with mid-flight
  joins, retirements inside a bucket and slot reuse: the same greedy
  tokens for every request, for TinyLlama, RecurrentGemma, RWKV6,
  StarCoder2-3B / 7B, Gemma2-2B (softcaps, alternating windows), Mixtral
  and DBRX (MoE; MusicGen and Qwen2-VL in their own files).
* The JAX engine tests' invariants (``tests/test_serving_engine.py``) on
  the port's engine: batched == solo, slot reuse, an empty step that does
  nothing and builds nothing, and joins that build nothing new.
* The ring fact: at window 64 and a 96-token prompt the JAX prefill +
  decode leaves its full forward by more than 10x the aligned baseline,
  while the port's decode equals the port's full forward.
* ``python -m repro_torch.launch.serve --device cpu --reduced`` runs
  without JAX, with and without ``--chaos-kill-every``; each resilience
  flag routes the run through the resilient serve loop, and each unported
  flag raises.
* ``snapshot`` / ``restore_snapshot`` round-trip the engine's state (the
  resilience tests hold them against the JAX package).
"""

import dataclasses
import subprocess
import tempfile
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _env import REPO_ROOT, SUBPROC_ENV
from repro.configs import get_reduced as jax_get_reduced
from repro.launch.steps import make_decode_step as jax_make_decode_step
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import PORTED_ARCHS, get_reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import Transformer, from_jax_params, load_arrays
from repro_torch.models.transformer import tree_leaves
from repro_torch.serving import Request, ServingEngine, gumbel_sampler, latest_snapshot

LOGIT_REL = 1e-4
PROMPT = 64  # the reduced windows' length: the JAX ring aligns
DECODE_STEPS = 4


def _setup(arch, seed=0):
    jcfg = jax_get_reduced(arch, param_dtype=jnp.float32)
    tcfg = get_reduced(arch, param_dtype=torch.float32)
    params = init_params(jax.random.PRNGKey(seed), jcfg)
    model = Transformer(tcfg, device="cpu", seed=None)
    load_arrays(model, from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    return jcfg, tcfg, params, model


def _close_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_REL * np.abs(want).max())


def _close_leaf(got: torch.Tensor, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and str(got.dtype).endswith(want.dtype.name)
    g, w = got.float().numpy(), want.astype(np.float32)
    if got.dtype == torch.bfloat16:
        # one bf16 rounding apart, of f32 values that differ by summation order
        assert np.all(np.abs(g - w) <= 2.0**-7 * np.abs(w) + 1e-4 * np.abs(w).max())
    elif got.dtype.is_floating_point:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-30))
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, tcfg, params, model = _setup(arch)
    tok = np.random.default_rng(1).integers(0, jcfg.vocab, size=(2, PROMPT)).astype(np.int32)
    max_seq = PROMPT + 8
    jlogits, jcaches = jax.jit(jax_make_prefill_step(jcfg, None, max_seq))(
        params, {"tokens": jnp.asarray(tok)})
    tlogits, tcaches = make_prefill_step(tcfg, max_seq)(model, {"tokens": torch.from_numpy(tok)})
    _close_logits(tlogits, jlogits)
    jleaves = jax.tree.leaves(jcaches)
    tleaves = tree_leaves(tcaches)
    assert len(tleaves) == len(jleaves)
    for got, want in zip(tleaves, jleaves):
        _close_leaf(got, want)

    jdecode = jax.jit(jax_make_decode_step(jcfg, None))
    tdecode = make_decode_step(tcfg)
    nxt = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for step in range(DECODE_STEPS):
        pos = PROMPT + step
        jl, jcaches = jdecode(params, jcaches, {"tokens": jnp.asarray(nxt[:, None])}, pos)
        tl, tcaches = tdecode(model, tcaches, {"tokens": torch.from_numpy(nxt[:, None])},
                              torch.tensor(pos, dtype=torch.int32))
        _close_logits(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for got, want in zip(tree_leaves(tcaches), jax.tree.leaves(jcaches)):
        _close_leaf(got, want)


def _stream(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, vocab, size=int(rng.choice([6, 10]))).astype(np.int32),
             int(rng.integers(2, 7))) for rid in range(n)]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b", "rwkv6-7b",
                                  "starcoder2-3b", "starcoder2-7b", "gemma2-2b",
                                  "mixtral-8x7b", "dbrx-132b"])
def test_engine_matches_reference_engine(arch):
    """One stream through both engines: three requests, two steps, three
    more joining mid-flight (retirements inside the bucket free slots
    that later requests reuse); the same greedy tokens for each."""
    jcfg, tcfg, params, model = _setup(arch)
    stream = _stream(jcfg.vocab)
    jeng = JaxServingEngine(jcfg, params, slots=2, max_seq=32)
    teng = ServingEngine(tcfg, model, slots=2, max_seq=32)
    for rid, prompt, n in stream[:3]:
        jeng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        teng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    for eng in (jeng, teng):
        eng.step()
        eng.step()
    for rid, prompt, n in stream[3:]:
        jeng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        teng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    want = {r.rid: r.generated for r in jeng.run_to_completion()}
    got = {r.rid: r.generated for r in teng.run_to_completion()}
    assert got == want
    assert len(got) == len(stream)
    stats = teng.compile_stats()
    assert stats["decode"] == 1 and stats["graph_captures"] == 0  # the CPU runs eagerly
    assert stats["admit"] == jeng.compile_stats()["admit"]


def _engine(slots=2, max_seq=64, **kw):
    tcfg = get_reduced("tinyllama-1.1b", param_dtype=torch.float32)
    model = Transformer(tcfg, device="cpu", seed=0)
    return ServingEngine(tcfg, model, slots=slots, max_seq=max_seq, **kw)


def test_single_request_matches_dedicated_engine():
    prompt_a = np.arange(10, 18, dtype=np.int32)
    prompt_b = np.arange(40, 48, dtype=np.int32)
    both = _engine(slots=2)
    both.submit(Request(rid=1, prompt=prompt_a, max_new_tokens=6))
    both.submit(Request(rid=2, prompt=prompt_b, max_new_tokens=6))
    done = {r.rid: r.generated for r in both.run_to_completion()}
    for rid, prompt in ((1, prompt_a), (2, prompt_b)):
        solo = _engine(slots=1)
        solo.submit(Request(rid=rid, prompt=prompt, max_new_tokens=6))
        assert done[rid] == solo.run_to_completion()[0].generated, f"request {rid}: batched != solo"


def test_slot_reuse_after_completion():
    eng = _engine(slots=2)
    for i, start in enumerate((0, 16, 32)):
        eng.submit(Request(rid=i, prompt=np.arange(start, start + 8, dtype=np.int32),
                           max_new_tokens=4))
    done = eng.run_to_completion()
    assert len(done) == 3  # the third request reused a freed slot
    assert all(len(r.generated) == 4 for r in done)


def test_empty_step_is_a_noop():
    """With nothing admitted ``step`` returns 0, builds nothing and
    launches nothing."""
    eng = _engine(slots=2)
    assert eng.step() == 0
    assert eng.step() == 0
    assert eng.compile_stats() == {"decode": 0, "admit": {}, "prefill": 0, "graph_captures": 0}
    assert eng.decode_launches == 0


def test_mid_bucket_retirement_keeps_tokens_identical():
    eng = _engine(slots=2)
    eng.submit(Request(rid=1, prompt=np.arange(10, 18, dtype=np.int32), max_new_tokens=3))
    eng.submit(Request(rid=2, prompt=np.arange(40, 48, dtype=np.int32), max_new_tokens=9))
    done = {r.rid: r.generated for r in eng.run_to_completion()}
    assert len(done[1]) == 3 and len(done[2]) == 9
    assert eng.compile_stats()["decode"] == 1
    solo = _engine(slots=1)
    solo.submit(Request(rid=2, prompt=np.arange(40, 48, dtype=np.int32), max_new_tokens=9))
    assert done[2] == solo.run_to_completion()[0].generated


def test_joins_build_nothing_new():
    """A 1-row join, then a 3-row join (bucket 4): one admit bucket each,
    and the decode step stays the one built at the first step."""
    eng = _engine(slots=4)
    eng.submit(Request(rid=0, prompt=np.arange(8, dtype=np.int32), max_new_tokens=6))
    eng.step()
    assert eng.compile_stats()["admit"] == {1: 1} and eng.compile_stats()["decode"] == 1
    for rid in (1, 2, 3):
        eng.submit(Request(rid=rid, prompt=np.arange(rid, rid + 8, dtype=np.int32),
                           max_new_tokens=6))
    eng.step()
    assert eng.compile_stats()["admit"] == {1: 1, 4: 1}
    assert len(eng.run_to_completion()) == 4
    assert eng.compile_stats()["decode"] == 1 and eng.compile_stats()["graph_captures"] == 0


def test_retire_and_resume_continue_the_request():
    """``retire(requeue=True)`` evicts a row with its partial output; a
    resumed request re-prefills prompt + generated[:-1] and its tokens
    equal an unbroken run's."""
    prompt = np.arange(20, 30, dtype=np.int32)
    ref = _engine(slots=1)
    ref.submit(Request(rid=0, prompt=prompt, max_new_tokens=6))
    want = ref.run_to_completion()[0].generated
    eng = _engine(slots=1)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=6))
    eng.step()
    eng.step()
    (req,) = eng.drain_requests()
    assert not req.done and len(req.generated) == 3 and not eng.active
    resumed = _engine(slots=1)
    resumed.submit(req)
    assert resumed.run_to_completion()[0].generated[:3] == want[:3]


def test_seeded_sampling_repeats():
    """A keyed sampler draws from the engine's generator: the same seed
    gives the same tokens, another seed others."""
    def run(seed):
        eng = _engine(slots=2, sample=gumbel_sampler(1.0), sample_seed=seed)
        for rid in range(3):
            eng.submit(Request(rid=rid, prompt=np.arange(rid, rid + 8, dtype=np.int32),
                               max_new_tokens=5))
        return {r.rid: r.generated for r in eng.run_to_completion()}

    assert run(2) == run(2)
    assert run(2) != run(3)


def test_probe_leaves_the_state_untouched():
    eng = _engine(slots=2)
    eng.submit(Request(rid=0, prompt=np.arange(8, dtype=np.int32), max_new_tokens=4))
    eng.step()
    before = [t.clone() for t in tree_leaves(eng._state)]
    assert eng.probe_step_time(repeats=2) > 0
    for a, b in zip(before, tree_leaves(eng._state)):
        assert torch.equal(a, b)


def test_training_after_serving_in_one_process():
    """The constants the model caches per device (RoPE frequencies, the tied
    embedding's scale) are made outside inference mode: a model that first
    serves, then trains, saves them for backward without error."""
    from repro_torch.models import layers, transformer

    layers._rope_freqs_on.cache_clear()
    transformer._constant.cache_clear()
    tcfg = get_reduced("recurrentgemma-9b", param_dtype=torch.float32)  # tied embeddings
    model = Transformer(tcfg, device="cpu", seed=0)
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab, (1, 9)))
    make_prefill_step(tcfg, 16)(model, {"tokens": tok})
    model.loss({"tokens": tok, "targets": tok}).backward()
    assert all(p.grad is not None for p in model.parameters())


def test_ring_fact_at_window_64_prompt_96():
    """The JAX prefill stores the trailing 64 of 96 keys at slots 0..63, so
    its first decode overwrites a key still inside the window: more than
    10x the aligned prompt's (64) gap to the full forward.  The port
    writes slot p % 64 and its decode equals its full forward."""
    arch = "recurrentgemma-9b"
    jcfg, tcfg, params, model = _setup(arch)
    assert jcfg.local_window == 64
    rng = np.random.default_rng(5)

    def jax_gap(prompt_len):
        tok = rng.integers(0, jcfg.vocab, size=(1, prompt_len + 1)).astype(np.int32)
        max_seq = prompt_len + 8
        _, caches = jax.jit(jax_make_prefill_step(jcfg, None, max_seq))(
            params, {"tokens": jnp.asarray(tok[:, :-1])})
        got, _ = jax.jit(jax_make_decode_step(jcfg, None))(
            params, caches, {"tokens": jnp.asarray(tok[:, -1:])}, prompt_len)
        # one query chunk: the JAX forward asserts that q_chunk divides S
        want, _, _ = jax_forward(params, dataclasses.replace(jcfg, q_chunk=128),
                                 tokens=jnp.asarray(tok))
        return float(np.abs(np.asarray(got) - np.asarray(want[:, -1])).max()), tok

    aligned, _ = jax_gap(64)
    misaligned, tok = jax_gap(96)
    assert misaligned > 10 * aligned, (aligned, misaligned)

    max_seq = 96 + 8
    _, caches = make_prefill_step(tcfg, max_seq, cache_dtype=torch.float32)(
        model, {"tokens": torch.from_numpy(tok[:, :-1])})
    got, _ = make_decode_step(tcfg)(model, caches, {"tokens": torch.from_numpy(tok[:, -1:])},
                                    torch.tensor(96, dtype=torch.int32))
    with torch.inference_mode():
        want, _, _ = model(torch.from_numpy(tok).long(), last_only=True)
    _close_logits(got, want[:, -1])


SERVE_WITHOUT_JAX = textwrap.dedent("""
    import runpy, sys
    sys.modules["jax"] = None
    sys.argv = ["serve"] + sys.argv[1:]
    runpy.run_module("repro_torch.launch.serve", run_name="__main__")
    assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
""")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-7b"])
def test_serve_cli_runs_on_cpu(arch, tmp_path):
    plan = tmp_path / "serve_plan.json"
    out = subprocess.run(
        [sys.executable, "-c", SERVE_WITHOUT_JAX, "--arch", arch, "--reduced", "--device", "cpu",
         "--slots", "2", "--requests", "3", "--prompt-lens", "8,12", "--tokens", "4",
         "--fabric", "gpu_nccl", "--plan-out", str(plan)],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
        env=dict(SUBPROC_ENV, OMP_NUM_THREADS="2"),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "serve_plan[mg_wfbp|gpu_nccl|all_gather]" in out.stdout
    assert "3 requests, 12 tokens" in out.stdout and "eager step on cpu" in out.stdout
    assert "observed step" in out.stdout and plan.exists()


def test_serve_cli_resilient_on_cpu(tmp_path):
    """Kills every 3 steps through the CLI, with no JAX in the process: the
    loop restarts and its tokens match the uninterrupted run's."""
    out = subprocess.run(
        [sys.executable, "-c", SERVE_WITHOUT_JAX, "--arch", "tinyllama-1.1b", "--reduced",
         "--device", "cpu", "--slots", "2", "--requests", "3", "--prompt-len", "8",
         "--tokens", "6", "--fabric", "gpu_nccl", "--chaos-kill-every", "3",
         "--snapshot-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
        env=dict(SUBPROC_ENV, OMP_NUM_THREADS="2"),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[serve] resilience: restarts=3" in out.stdout
    assert "tokens_match=True" in out.stdout and "3 requests, 18 tokens" in out.stdout


@pytest.mark.parametrize("flags, item", [
    (["--sharded"], "CUDA is not available"),
    (["--measure-comm"], "CUDA is not available"),
])
def test_unported_serve_flags_raise(flags, item):
    """``--sharded`` and ``--measure-comm`` (ported since; they run in
    ``tests/test_torch_sharded_serving.py``) start no process group and
    fall back to no CPU world without ``--device cpu``: they raise here."""
    with pytest.raises(RuntimeError, match=item):
        serve_cli.run(["--arch", "tinyllama-1.1b", "--reduced", *flags], quiet=True)


@pytest.mark.parametrize("flag", [
    ["--chaos-kill-every", "3"],
    ["--chaos-seed", "1"],
    ["--chaos-slow-factor", "2"],
    ["--chaos-slow-after", "4"],
    ["--deadline-ms", "600000"],
    ["--snapshot-every", "4"],
    ["--snapshot-dir", "DIR"],
    ["--max-restarts", "2"],
], ids=lambda f: f[0][2:])
def test_resilience_flags_run_the_loop(flag, tmp_path, monkeypatch):
    """Each resilience flag alone routes the run through
    ``resilient_serve_loop`` and completes every request."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the default snapshot directory
    snap_dir = tmp_path / "snapshots"
    flag = [str(snap_dir) if f == "DIR" else f for f in flag]
    res = serve_cli.run(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
                         "--slots", "2", "--requests", "3", "--prompt-len", "8", "--tokens", "6",
                         *flag], quiet=True)
    rep = res.report
    assert rep is not None and not rep.interrupted
    assert len(res.completed) == 3 and res.n_tokens == 18
    assert rep.shed == rep.expired == rep.replans == 0
    kills = flag[0] == "--chaos-kill-every"
    assert rep.restarts == len(rep.recovery_times_s) and (rep.restarts > 0) == kills
    assert (res.tokens_match is True) if kills else (res.tokens_match is None)
    every = 4 if flag[0] == "--snapshot-every" else 8
    if not kills:
        assert rep.snapshots == 1 + rep.steps // every
    if flag[0] == "--snapshot-dir":
        assert latest_snapshot(str(snap_dir)) is not None


def test_snapshot_and_mesh_raise():
    """``snapshot`` / ``restore_snapshot`` round-trip the state into another
    engine, which then finishes with the unbroken tokens; ``mesh=`` without a
    ``ServePlan`` raises, as in the JAX engine."""
    ref = _engine(slots=2)
    eng = _engine(slots=2)
    for e in (ref, eng):
        for rid in range(3):
            e.submit(Request(rid=rid, prompt=np.arange(rid, rid + 8, dtype=np.int32),
                             max_new_tokens=5))
    want = {r.rid: r.generated for r in ref.run_to_completion()}
    eng.step()
    eng.step()
    snap = eng.snapshot(step=2)
    other = _engine(slots=2)
    other.restore_snapshot(snap)
    for a, b in zip(tree_leaves(other._state), tree_leaves(eng._state)):
        assert torch.equal(a, b)
    assert {r.rid: r.generated for r in other.run_to_completion()} == want
    with pytest.raises(ValueError, match="requires a ServePlan"):
        _engine(slots=1, mesh=object())
