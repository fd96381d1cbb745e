"""The port's ``runtime/compression.py`` against the JAX package's, and
the collectives it brings through the counted ``issue()`` seam.

* ``bf16_ef_encode`` / ``bf16_ef_decode``: bit for bit the JAX package's
  on the same f32 and bf16 gradients and residuals, and bit for bit the
  fused EF of ``kernels/comm_pack/ref.py``'s ``pack_arena_ref`` (the
  arena path's arithmetic); ``ef_init`` gives f32 zeros.
* ``compressed_psum_rs_ag`` on 4 gloo ranks (one process each) against
  the JAX package's under ``shard_map`` on 4 virtual CPU devices, the same
  per-rank gradients and residuals from a numpy seed, sizes that need
  padding and sizes that do not.  Dyadic gradients (multiples of 2^-6
  below 1) sum exactly in any order, so the summed gradient must be
  bitwise equal.  The residual ``shard - q * scale`` is not: XLA's CPU
  compiler contracts it into one fused multiply-subtract (``jax.jit(lambda
  a, b, c: a - b * c)`` equals the exact result rounded once), while the
  port rounds the product first, as the source reads.  So each residual
  element is held to 2^-23 x |the sum| there: the product's rounding and
  the subtraction's.  On normal gradients gloo and
  XLA may add the four shards in other orders, which may move a code
  across a .5 boundary: each element of the sum must equal the JAX one or
  lie within one quantization step (the largest scale, 1e-6 relative
  slack for the scale's own last bit) of it, and each residual element
  likewise.  The plain version, ``compressed_psum_rs_ag_ref``, holds the
  gloo result bitwise on the dyadic cases.
* ``issue.calls`` rises by exactly 3 per call (reduce-scatter and two
  all-gathers), on every rank; at world 1 the call equals the plain
  version bitwise; ``issue`` refuses a gather, scatter or all-to-all
  without an output, and a list of tensors for any op but ``all_reduce``.
"""

import json
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _env import REPO_ROOT, SUBPROC_ENV
from _torch_env import bits, to_torch, world1
from repro.runtime import compression as jax_comp
from repro_torch.fabric.ops import issue
from repro_torch.kernels.comm_pack.ref import pack_arena_ref
from repro_torch.runtime import compression as comp

WORLD = 4
#: name -> (per-rank shape, gradients dyadic or normal, residual given)
CASES = {
    "dyadic-pad": ((10, 3), "dyadic", True),
    "dyadic-1024": ((1024,), "dyadic", False),
    "normal-pad": ((7, 5), "normal", True),
    "normal-4096": ((64, 64), "normal", False),
}


def _draw(kind, shape, rng):
    if kind == "dyadic":
        return (rng.integers(-63, 64, shape) / 64.0).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("gdtype", ["f32", "bf16"])
def test_bf16_ef_encode_decode_match_reference_and_pack_arena(gdtype):
    rng = np.random.default_rng(0)
    g32 = (rng.standard_normal((257, 9)) * 10.0 ** rng.integers(-6, 6, (257, 9))).astype(np.float32)
    res = (rng.standard_normal((257, 9)) * 1e-3).astype(np.float32)
    jg = jnp.asarray(g32).astype(jnp.bfloat16 if gdtype == "bf16" else jnp.float32)
    tg = to_torch(np.asarray(jg))
    jwire, jres = jax_comp.bf16_ef_encode(jg, jnp.asarray(res))
    wire, new_res = comp.bf16_ef_encode(tg, torch.from_numpy(res))
    assert wire.dtype == torch.bfloat16 and new_res.dtype == torch.float32
    assert np.array_equal(bits(wire), bits(np.asarray(jwire)))
    assert np.array_equal(bits(new_res), bits(np.asarray(jres)))
    arena, (arena_res,) = pack_arena_ref([tg], [0], tg.numel(), torch.bfloat16,
                                         residuals=[torch.from_numpy(res)])
    assert np.array_equal(bits(arena), bits(wire.reshape(-1)))
    assert np.array_equal(bits(arena_res), bits(new_res.reshape(-1)))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = comp.bf16_ef_decode(wire, dtype, scale=1.0 / 3.0)
        want = jax_comp.bf16_ef_decode(jwire, jdtype, scale=1.0 / 3.0)
        assert got.dtype == dtype and np.array_equal(bits(got), bits(np.asarray(want)))
    zeros = comp.ef_init({"a": tg, "b": torch.ones(3, dtype=torch.bfloat16)}).residual
    assert {k: (v.dtype, tuple(v.shape)) for k, v in zeros.items()} == \
        {"a": (torch.float32, (257, 9)), "b": (torch.float32, (3,))}
    assert all(not v.any() for v in zeros.values())


JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, set_mesh, shard_map
    from repro.runtime.compression import compressed_psum_rs_ag

    d, names = sys.argv[1], sys.argv[2].split(",")
    mesh = make_mesh((4,), ("dp",))
    for name in names:
        g = np.load(f"{d}/{name}_g.npy")  # (4, *shape): one row per device
        with_res = os.path.exists(f"{d}/{name}_r.npy")
        if with_res:
            body = lambda g, r: compressed_psum_rs_ag(g, "dp", r)
            args = (g, np.load(f"{d}/{name}_r.npy"))
        else:
            body = lambda g: compressed_psum_rs_ag(g, "dp")
            args = (g,)
        f = jax.jit(shard_map(body, mesh=mesh, axis_names={"dp"},
                              in_specs=(P("dp"),) * len(args), out_specs=(P("dp"), P("dp")),
                              check_vma=False))
        with set_mesh(mesh):
            full, res = f(*args)
        np.save(f"{d}/{name}_jax_full.npy", np.asarray(full))
        np.save(f"{d}/{name}_jax_res.npy", np.asarray(res))
    print("ok")
""")

RANK_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch, torch.distributed as dist
    from repro_torch.fabric.ops import issue
    from repro_torch.runtime import compressed_psum_rs_ag

    rank, port, d, names = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4].split(",")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    calls = []
    for name in names:
        g = torch.from_numpy(np.load(f"{d}/{name}_g.npy")[rank])
        r = (torch.from_numpy(np.load(f"{d}/{name}_r.npy")[rank])
             if os.path.exists(f"{d}/{name}_r.npy") else None)
        before = issue.calls
        full, res = compressed_psum_rs_ag(g, None, r)
        calls.append(issue.calls - before)
        np.save(f"{d}/{name}_torch_full_{rank}.npy", full.numpy())
        np.save(f"{d}/{name}_torch_res_{rank}.npy", res.numpy())
    dist.destroy_process_group()
    print(json.dumps({"calls": calls}))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Both packages on every case: JAX on 4 virtual devices, the port on 4
    gloo ranks; returns (inputs, outputs, issue calls per rank)."""
    d = tmp_path_factory.mktemp("rs_ag")
    rng = np.random.default_rng(21)
    inputs = {}
    for name, (shape, kind, with_res) in CASES.items():
        g = np.stack([_draw(kind, shape, rng) for _ in range(WORLD)])
        r = np.stack([_draw(kind, shape, rng) / 8 for _ in range(WORLD)]) if with_res else None
        np.save(d / f"{name}_g.npy", g)
        if r is not None:
            np.save(d / f"{name}_r.npy", r)
        inputs[name] = (g, r)
    names = ",".join(CASES)
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(d), names],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=REPO_ROOT)]
    procs += [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(port), str(d),
                                names],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                               env=env, cwd=REPO_ROOT)
              for r in range(WORLD)]
    calls = []
    try:
        for i, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, stderr[-3000:]
            if i:
                calls.append(json.loads(stdout.strip().splitlines()[-1])["calls"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outputs = {}
    for name in CASES:
        outputs[name] = {
            "jax_full": np.load(d / f"{name}_jax_full.npy"),
            "jax_res": np.load(d / f"{name}_jax_res.npy"),
            "full": np.stack([np.load(d / f"{name}_torch_full_{r}.npy") for r in range(WORLD)]),
            "res": np.stack([np.load(d / f"{name}_torch_res_{r}.npy") for r in range(WORLD)]),
        }
    return inputs, outputs, calls


def _step(inputs, name):
    """The largest quantization step of a case: max |shard sum| / 127."""
    g, r = inputs[name]
    total = g.astype(np.float64).sum(0) + (0 if r is None else r.astype(np.float64).sum(0))
    return float(np.abs(total).max()) / 127.0


@pytest.mark.parametrize("name", list(CASES))
def test_rs_ag_on_four_gloo_ranks_matches_shard_map(name, four_ranks):
    inputs, outputs, calls = four_ranks
    out = outputs[name]
    shape = CASES[name][0]
    assert out["full"].shape == out["jax_full"].shape == (WORLD, *shape)
    assert out["full"].dtype == out["res"].dtype == np.float32
    for r in range(1, WORLD):  # every rank holds the same sum
        assert np.array_equal(bits(out["full"][r]), bits(out["full"][0]))
    if CASES[name][1] == "dyadic":
        assert np.array_equal(bits(out["full"]), bits(out["jax_full"]))
        bound = 2.0 ** -23 * np.abs(out["full"])
        assert bool(np.all(np.abs(out["res"] - out["jax_res"]) <= bound))
        g, r = inputs[name]
        rows = [torch.from_numpy(x) for x in g]
        res = None if r is None else [torch.from_numpy(x) for x in r]
        ref_full, ref_res = comp.compressed_psum_rs_ag_ref(rows, res)
        for k in range(WORLD):
            assert np.array_equal(bits(ref_full[k]), bits(out["full"][k]))
            assert np.array_equal(bits(ref_res[k]), bits(out["res"][k]))
    else:
        step = _step(inputs, name) * (1 + 1e-6)
        for got, want in ((out["full"], out["jax_full"]), (out["res"], out["jax_res"])):
            same = bits(got) == bits(want)
            assert bool(np.all(same | (np.abs(got - want) <= step))), name
    # each rank's residual is its own shard's error: zero outside that shard
    flat = out["res"].reshape(WORLD, -1)
    size = flat.shape[1]
    shard = -(-size // WORLD)
    for k in range(WORLD):
        outside = np.ones(size, bool)
        outside[k * shard:(k + 1) * shard] = False
        assert not flat[k][outside].any()
    assert calls == [[3] * len(CASES)] * WORLD


def test_rs_ag_at_world1_equals_the_plain_version():
    world1()
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.standard_normal((33, 7)).astype(np.float32)).to(torch.bfloat16)
    r = torch.from_numpy(rng.standard_normal((33, 7)).astype(np.float32) * 1e-3)
    before = issue.calls
    full, res = comp.compressed_psum_rs_ag(g, None, r)
    assert issue.calls == before + 3
    (ref_full,), (ref_res,) = comp.compressed_psum_rs_ag_ref([g], [r])
    assert full.shape == res.shape == g.shape and full.dtype == torch.float32
    assert np.array_equal(bits(full), bits(ref_full)) and np.array_equal(bits(res), bits(ref_res))
    # the codes reach +-127 and the error stays under half a step
    scale = float((g.float() + r).abs().max()) / 127.0
    assert float((full - (g.float() + r)).abs().max()) <= 0.5 * scale * (1 + 1e-6)


def test_issue_refuses_what_it_cannot_issue():
    world1()
    x = torch.zeros(4)
    before = issue.calls
    for op in ("reduce_scatter", "all_gather", "all_to_all"):
        with pytest.raises(ValueError, match="output tensor"):
            issue(op, x)
        with pytest.raises(ValueError, match="takes one tensor"):
            issue(op, [x], out=x.clone())
    assert issue.calls == before
