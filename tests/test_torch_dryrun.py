"""The port's dry run (``repro_torch.launch.{dryrun,segments,specs}``)
against the JAX package's, on the CPU.

* ``model_flops_per_step`` for every arch x applicable shape, and
  ``plan_record`` (analytic, and with one given ``segments`` dict: measured
  and re-planned), ``serve_plan_record`` and ``recompose`` under the v5e
  constants, for every arch x mesh: the JSON records equal.  The JAX
  functions get a stub mesh (``axis_names`` and ``devices``, all they read).
* The four segments of reduced TinyLlama, Mixtral and RecurrentGemma on a
  fake 2x4 world (``fsdp_data=True``, batch 2 x 128) against the JAX
  segments on 8 virtual CPU devices, each side in a subprocess of its own
  (a fake world cannot start where a process group exists).  The port counts the
  matmul-class flops only (``torch.utils.flop_counter``), XLA's count also
  holds the elementwise ones: each port count must lie in [0.6, 1.0] x the
  JAX count (measured 0.64-0.99; Mixtral's stages 0.96 and 0.89, as GSPMD
  computes them: the MoE combine on each rank's experts, the decode-EP
  expert tables used where they lie).  The collective kinds the rules imply
  must appear on both sides:
  all-gather of the FSDP weights in every segment, a gradient all-reduce in
  every train segment, the MoE all-to-all in Mixtral's (EP) stages.
* One rank's local stage segment (``stage_train_local`` on ``meta``, under
  ``FlopCounterMode``) counts exactly the fake world's per-device flops.
* The CLI end to end (``--device cpu``, TinyLlama x train_4k on the
  16x16 fake world at reduced widths and depth), with ``jax`` blocked:
  a record with the JAX record's keys, the peak printed, and its
  collectives by kind, for the whole step and each segment, exactly
  ``PINNED_COUNTS`` (counted by the placement rule, they do not depend on
  the torch version: ``chip_smoke.py`` phase 10 gates the card's torch on
  the same numbers).
* The JAX model's chunked WKV as the dry run runs it, against the JAX one.
* ``--remat``: the port CLI offers the JAX CLI's choices, ``'dots'``
  included.  On reduced TinyLlama at batch 8 x 256 (q_chunk 128) on the 2x4
  world, the whole step's flops order full > dots >= none and its peaks
  full <= dots <= none, on the fake world and in XLA's record of the JAX
  step on 8 virtual devices; on the fake world full - dots is exactly the
  2·M·N·K of the products ``'dots'`` saves (q, k, v, o, gate, up), which
  ``'full'`` recomputes.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

from _env import REPO_ROOT, SUBPROC_ENV

_xla_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as jdry  # noqa: E402  (its import sets XLA_FLAGS for its CLI)

if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced  # noqa: E402
from repro_torch.configs.shapes import SHAPES, applicable_shapes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SEG_ARCHS = ("tinyllama-1.1b", "mixtral-8x7b", "recurrentgemma-9b")
SEG_NAMES = ("stage_train_segment", "stage_fwd_segment", "head_train_segment", "head_fwd_segment")
LOWER, UPPER = 0.6, 1.0
#: the reduced CLI cell's collectives by kind (chip_smoke.py's DRYRUN_REDUCED_COUNTS)
PINNED_COUNTS = {
    "whole_program": {"all-gather": 86, "reduce-scatter": 32, "all-reduce": 14},
    "stage": {"all-gather": 28, "reduce-scatter": 14, "all-reduce": 4},
    "head": {"all-gather": 6, "reduce-scatter": 4, "all-reduce": 2},
}
B, S = 2, 128

JAX_SEGMENTS = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from repro.configs import get_reduced
    from repro.launch import segments
    from repro.launch.mesh import make_mesh
    from repro.launch.specs import moe_groups_for
    from repro.parallel.sharding import rules_for_arch
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = dataclasses.replace(get_reduced(arch), q_chunk=128, chunk_impl="unroll",
                                  remat="none")
        rules = rules_for_arch(cfg, mesh, fsdp_data=True)
        cfg = dataclasses.replace(cfg, moe_groups=moe_groups_for(rules, %(B)d, %(S)d))
        for name in sys.argv[2].split(","):
            c = getattr(segments, name)(cfg, rules, mesh, %(B)d, %(S)d)
            out[arch + "/" + name] = dataclasses.asdict(c)
    print(json.dumps(out))
""" % {"B": B, "S": S})


REMAT_B, REMAT_S, REMAT_Q_CHUNK = 8, 256, 128

JAX_REMAT_CELL = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from types import SimpleNamespace
    import jax
    from repro.compat import set_mesh
    from repro.configs import get_reduced
    from repro.launch.mesh import make_mesh
    from repro.launch.specs import batch_input_specs, opt_state_specs, param_specs
    from repro.launch.steps import make_train_step
    from repro.optim import make_optimizer
    from repro.optim.optimizers import OptState
    from repro.parallel.sharding import batch_specs, named, param_pspecs, rules_for_arch
    mesh = make_mesh((2, 4), ("data", "model"))
    B, S = %(B)d, %(S)d
    shape = SimpleNamespace(kind="train", global_batch=B, seq_len=S)
    out = {}
    for remat in ("full", "dots", "none"):
        cfg = dataclasses.replace(get_reduced("tinyllama-1.1b"), remat=remat, q_chunk=%(Q)d)
        rules = rules_for_arch(cfg, mesh, fsdp_data=True)
        p_shapes = param_specs(cfg)
        p_sh = named(param_pspecs(p_shapes, rules), mesh)
        opt = make_optimizer("adamw")
        o_sh = OptState(step=jax.NamedSharding(mesh, jax.sharding.PartitionSpec()), m=p_sh, v=p_sh)
        b_sh = named(batch_specs(cfg, rules, B, S), mesh)
        with set_mesh(mesh):
            compiled = jax.jit(make_train_step(cfg, rules, opt), in_shardings=(p_sh, o_sh, b_sh),
                               out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1)).lower(
                p_shapes, opt_state_specs(cfg, opt), batch_input_specs(cfg, shape)).compile()
        ma, ca = compiled.memory_analysis(), compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, list) else ca
        out[remat] = {"flops": float(ca["flops"]),
                      "peak": ma.argument_size_in_bytes + ma.output_size_in_bytes
                              + ma.temp_size_in_bytes - ma.alias_size_in_bytes}
    print(json.dumps(out))
""" % {"B": REMAT_B, "S": REMAT_S, "Q": REMAT_Q_CHUNK})

PORT_REMAT_CELL = textwrap.dedent("""
    import dataclasses, json, sys
    sys.modules["jax"] = None
    from types import SimpleNamespace
    from repro_torch.configs import get_reduced
    from repro_torch.launch import dryrun, segments
    from repro_torch.parallel.sharding import rules_for_arch
    B, S = %(B)d, %(S)d
    shape = SimpleNamespace(kind="train", global_batch=B, seq_len=S)
    out = {}
    with segments.fake_world(8):
        mesh = segments.fake_mesh((2, 4), ("data", "model"))
        for remat in ("full", "dots", "none"):
            cfg = dataclasses.replace(get_reduced("tinyllama-1.1b"), remat=remat,
                                      attn_impl="plain", q_chunk=%(Q)d)
            rules = rules_for_arch(cfg, mesh, fsdp_data=True)
            mem, whole = dryrun._run_step(cfg, shape, rules, mesh, 1)
            out[remat] = {"flops": whole["flops_per_device"],
                          "peak": mem["argument_bytes"] + mem["output_bytes"]
                                  + mem["temp_bytes"] - mem["alias_bytes"],
                          "batch_axes": rules.batch_axes(B)}
    print(json.dumps(out))
""" % {"B": REMAT_B, "S": REMAT_S, "Q": REMAT_Q_CHUNK})


def jax_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def port_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(mesh_dim_names=axes, shape=shape)


def dumps(rec) -> str:
    return json.dumps(rec, sort_keys=True)


def segs_for(cfg) -> dict:
    segs = {"stage": {"flops": 3.1e12, "bytes_accessed": 2.2e11},
            "head": {"flops": 4.7e11, "bytes_accessed": 6.1e10}}
    if cfg.tail_pattern:
        segs["tail"] = {"flops": 1.3e12, "bytes_accessed": 9.0e10}
    return segs


def test_model_flops_per_step_equal():
    for arch in ARCH_NAMES:
        for name in applicable_shapes(arch):
            assert dryrun.model_flops_per_step(get_config(arch), SHAPES[name]) == \
                jdry.model_flops_per_step(jax_config(arch), JAX_SHAPES[name]), (arch, name)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_plan_records_equal(arch, capsys):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    v5e = dryrun.TPU_V5E_ROOFLINE
    for mesh in MESHES:
        n_dev = int(np.prod(MESHES[mesh][0]))
        for fabric in ("tpu_v5e", "gpu_nccl"):
            shape = SHAPES["train_4k"]
            for segs in (None, segs_for(tcfg)):
                want = jdry.plan_record(jcfg, JAX_SHAPES["train_4k"], segs, jax_mesh(mesh), n_dev,
                                        fabric=fabric)
                got = dryrun.plan_record(tcfg, shape, segs, port_mesh(mesh), n_dev, fabric=fabric,
                                         roofline=v5e)
                assert dumps(got) == dumps(want), (arch, mesh, fabric, segs is None)
                if segs:
                    assert "measured" in got and "replanned" in got
            fit = {"sizes_bytes": [1 << 10, 1 << 20, 1 << 24], "times_s": [2e-5, 1e-4, 1.3e-3]}
            want = jdry.plan_record(jcfg, JAX_SHAPES["train_4k"], None, jax_mesh(mesh), n_dev,
                                    comm_fit=fit)
            got = dryrun.plan_record(tcfg, shape, None, port_mesh(mesh), n_dev, comm_fit=fit,
                                     roofline=v5e)
            assert dumps(got) == dumps(want), (arch, mesh, "comm_fit")
            for name in ("decode_32k", "long_500k"):
                if name not in applicable_shapes(arch):
                    continue
                want = jdry.serve_plan_record(jcfg, JAX_SHAPES[name], jax_mesh(mesh), fabric=fabric)
                got = dryrun.serve_plan_record(tcfg, SHAPES[name], port_mesh(mesh), fabric=fabric,
                                               roofline=v5e)
                assert dumps(got) == dumps(want), (arch, mesh, fabric, name)
        rec = {"segments": {k: {**v, "coll_bytes": {"all-gather": 7 << 20}}
                            for k, v in segs_for(tcfg).items()}}
        for name in applicable_shapes(arch):
            assert dryrun.recompose(tcfg, SHAPES[name], rec, n_dev, v5e) == \
                jdry.recompose(jcfg, JAX_SHAPES[name], rec, n_dev), (arch, mesh, name)
    capsys.readouterr()


def _start(tmp_path_factory, name, *argv):
    """``argv`` in a subprocess started at once (XLA's warnings go to a
    file, so no pipe fills while the port's side runs)."""
    err = tmp_path_factory.mktemp(name) / "stderr.txt"
    with open(err, "w") as errf:
        proc = subprocess.Popen(
            [sys.executable, "-c", *argv],
            stdout=subprocess.PIPE, stderr=errf, text=True, cwd=REPO_ROOT,
            env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"))
    proc.stderr_path = err
    return proc


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_segments(tmp_path_factory):
    """The JAX segments, started at once in a subprocess."""
    proc = _start(tmp_path_factory, "jax_segments", JAX_SEGMENTS, ",".join(SEG_ARCHS),
                  ",".join(SEG_NAMES))
    yield proc
    _stop(proc)


@pytest.fixture(scope="module")
def jax_remat_cell(tmp_path_factory):
    """XLA's record of the JAX remat cell, started at once in a subprocess."""
    proc = _start(tmp_path_factory, "jax_remat_cell", JAX_REMAT_CELL)
    yield proc
    _stop(proc)


PORT_SEGMENTS = textwrap.dedent("""
    import dataclasses, json, sys
    sys.modules["jax"] = None  # any import of jax now raises
    from repro_torch.configs import get_reduced
    from repro_torch.launch import segments
    from repro_torch.launch.specs import moe_groups_for
    from repro_torch.parallel.sharding import rules_for_arch
    out = {}
    with segments.fake_world(8):
        mesh = segments.fake_mesh((2, 4), ("data", "model"))
        for arch in sys.argv[1].split(","):
            cfg = dataclasses.replace(get_reduced(arch), q_chunk=128, remat="none",
                                      attn_impl="plain")
            rules = rules_for_arch(cfg, mesh, fsdp_data=True)
            cfg = dataclasses.replace(cfg, moe_groups=moe_groups_for(rules, %(B)d, %(S)d))
            for name in sys.argv[2].split(","):
                c = getattr(segments, name)(cfg, rules, mesh, %(B)d, %(S)d)
                out[arch + "/" + name] = dataclasses.asdict(c)
    print(json.dumps(out))
""" % {"B": B, "S": S})

LOCAL_SEGMENT = textwrap.dedent("""
    import dataclasses, json, sys
    sys.modules["jax"] = None
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_reduced
    from repro_torch.launch import segments
    from repro_torch.parallel.sharding import rules_for_arch
    cfg = dataclasses.replace(get_reduced("tinyllama-1.1b"), q_chunk=64, remat="none",
                              attn_impl="plain")
    with segments.fake_world(8):
        mesh = segments.fake_mesh((2, 4), ("data", "model"))
        rules = rules_for_arch(cfg, mesh, fsdp_data=True)
        batch_axes = rules.batch_axes(8)
        fake = segments.stage_train_segment(cfg, rules, mesh, 8, 128).flops
    run = segments.stage_train_local(cfg, 1, 128, "meta")
    with FlopCounterMode(display=False) as fc:
        run()
    print(json.dumps({"batch_axes": batch_axes, "fake": fake, "local": fc.get_total_flops()}))
""")


def run_json(script: str, *args: str) -> dict:
    """``script`` in a fresh process (a fake world of its own, whatever
    process group this worker holds), its last stdout line as JSON."""
    out = subprocess.run([sys.executable, "-c", script, *args], capture_output=True, text=True,
                         timeout=600, cwd=REPO_ROOT, env=dict(SUBPROC_ENV, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_segments_against_the_jax_segments_on_a_2x4_mesh(jax_segments):
    got = run_json(PORT_SEGMENTS, ",".join(SEG_ARCHS), ",".join(SEG_NAMES))
    stdout, _ = jax_segments.communicate(timeout=600)
    assert jax_segments.returncode == 0, jax_segments.stderr_path.read_text()[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    ratios = {}
    for key, w in want.items():
        g = got[key]
        arch, name = key.split("/")
        ratio = g["flops"] / w["flops"]
        ratios[key] = round(ratio, 4)
        assert LOWER <= ratio <= UPPER, (key, ratio)
        implied = {"all-gather"}
        if "train" in name:
            implied.add("all-reduce")
        if arch == "mixtral-8x7b" and name.startswith("stage"):
            implied.add("all-to-all")
        for side, rec in (("port", g), ("jax", w)):
            assert implied <= set(rec["coll_counts"]), (key, side, rec["coll_counts"])
    print("port / jax flops:", ratios)


def test_one_ranks_local_segment_counts_the_fake_worlds_per_device_flops():
    rec = run_json(LOCAL_SEGMENT)
    assert rec["batch_axes"] == ["data", "model"]  # one row a rank
    assert rec["local"] == rec["fake"]


def _run_cli(tmp_path, *extra: str) -> dict:
    """The CLI on reduced TinyLlama x train_4k with ``jax`` blocked, run to
    its end: the record it wrote."""
    red = get_reduced("tinyllama-1.1b")
    over = {"n_layers": 2, "d_model": red.d_model, "d_ff": red.d_ff, "vocab": red.vocab}
    out = tmp_path / "rec.json"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent("""
            import json, sys
            sys.modules["jax"] = None
            from repro_torch.launch import dryrun
            from repro_torch.models.common import Attention
            over = json.loads(sys.argv[-1])
            over["attention"] = Attention(**over["attention"])
            code = dryrun.main(sys.argv[1:-1], overrides=over)
            assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
            sys.exit(code)
        """), "--device", "cpu", "--arch", "tinyllama-1.1b", "--shape", "train_4k",
         "--fabric", "gpu_nccl", "--out", str(out), *extra,
         json.dumps({**over, "attention": dataclasses.asdict(red.attention)})],
        capture_output=True, text=True, timeout=600, cwd=REPO_ROOT,
        env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "peak_per_device_gib" in proc.stdout and "dry-run complete: 1 ok, 0 failed" in proc.stdout
    return json.loads(out.read_text())


def _check_record(rec: dict) -> None:
    assert set(rec) == {"arch", "shape", "mesh", "n_devices", "fsdp_data", "n_microbatches",
                        "compile_s", "memory", "whole_program", "segments", "totals", "plan"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                                  "peak_per_device_gib"}
    assert set(rec["whole_program"]) == {"flops_per_device", "bytes_accessed", "collectives"}
    assert set(rec["whole_program"]["collectives"]) == {"counts", "bytes_by_kind", "concat_ops"}
    assert set(rec["segments"]) == {"stage", "head"}
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["memory"]["peak_per_device_gib"] > 0 and rec["whole_program"]["flops_per_device"] > 0
    for key in ("dominant", "roofline_fraction", "compute_term_s", "memory_term_s",
                "collective_term_s"):
        assert key in rec["totals"]
    assert {"analytic", "arena", "measured", "replanned"} <= set(rec["plan"])


def test_cli_writes_a_record_with_the_jax_keys(tmp_path):
    rec = _run_cli(tmp_path)
    _check_record(rec)
    got = {"whole_program": rec["whole_program"]["collectives"]["counts"],
           **{name: rec["segments"][name]["coll_counts"] for name in ("stage", "head")}}
    assert got == PINNED_COUNTS


def test_cli_runs_a_dots_cell(tmp_path):
    _check_record(_run_cli(tmp_path, "--remat", "dots"))


def test_wkv_jax_chunked_matches_the_jax_model():
    """The dry run's WKV on DTensors is the JAX model's chunked form
    (``wkv_chunked``), ported op for op: equal to it on small inputs, a
    length off the chunk grid and an initial state included (f32 sums in
    another order: 1e-5)."""
    import jax.numpy as jnp
    import torch

    from repro.models.rwkv6 import wkv_chunked
    from repro_torch.models.rwkv6 import wkv_jax_chunked

    rng = np.random.default_rng(0)
    B, T, H, K = 2, 70, 2, 8
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.6, 0.99, (B, T, H, K)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    for state in (None, s0):
        args = (r, k, v, w, u) + (() if state is None else (state,))
        jo, js = wkv_chunked(*(jnp.asarray(a) for a in args), chunk=16)
        to, ts = wkv_jax_chunked(*(torch.from_numpy(a) for a in args), chunk=16)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def _choices(main, argv, capsys) -> str:
    """The ``(choose from ...)`` of an argparse error on ``--remat``."""
    with pytest.raises(SystemExit):
        main(argv)
    err = capsys.readouterr().err
    return err[err.index("(choose from"):].splitlines()[0]


def test_remat_choices_equal_the_jax_cli(capsys, monkeypatch):
    argv = ["--remat", "offload"]
    monkeypatch.setattr(sys, "argv", ["dryrun", *argv])
    want = _choices(lambda _: jdry.main(), argv, capsys)
    assert "'dots'" in want or " dots" in want
    assert _choices(dryrun.main, argv, capsys) == want


def test_remat_orders_flops_and_peaks_on_a_2x4_cell(jax_remat_cell):
    got = run_json(PORT_REMAT_CELL)
    stdout, _ = jax_remat_cell.communicate(timeout=600)
    assert jax_remat_cell.returncode == 0, jax_remat_cell.stderr_path.read_text()[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    for side, rec in (("port", got), ("jax", want)):
        full, dots, none = rec["full"], rec["dots"], rec["none"]
        assert full["flops"] > dots["flops"] >= none["flops"], (side, rec)
        assert full["peak"] <= dots["peak"] <= none["peak"], (side, rec)
    # one row of 256 tokens a rank; the saved products of each layer
    assert got["dots"]["batch_axes"] == ["data", "model"]
    cfg, att = get_reduced("tinyllama-1.1b"), get_reduced("tinyllama-1.1b").attention
    d, qd, kvd = cfg.d_model, att.n_heads * att.head_dim, att.n_kv_heads * att.head_dim
    per_token = d * qd + 2 * d * kvd + qd * d + 2 * d * cfg.d_ff  # q, k, v, o, gate, up
    tokens = REMAT_B * REMAT_S // 8
    assert got["full"]["flops"] - got["dots"]["flops"] == 2 * tokens * per_token * cfg.n_layers
