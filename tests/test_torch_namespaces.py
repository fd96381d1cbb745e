"""The port's package namespaces against the JAX package's.

* Every name of each JAX subpackage's ``__all__`` resolves on the port's
  subpackage of the same name, or stands in ``OTHER_FORM`` (the names the
  port has in another form, each with its reason).  One case a subpackage;
  one more walks the JAX package's modules, each with a counterpart but
  ``compat``.
* ``repro_torch.core``'s aliases are the JAX ones' kinds: ``TPU_V5E`` the
  cost model's ``Hardware`` preset, ``TPU_V5E_ICI`` the comm model's
  interconnect, with the same fields.
* ``import repro_torch.core`` alone imports no submodule, and the planning
  math it resolves loads without the trainer.
* ``tree_set`` equals the JAX ``tree_set`` on nested dicts, lists and
  tuples, and leaves its input as it was.
* ``param_count`` and ``describe_params`` equal the JAX functions on every
  reduced arch, the weights carried across by ``from_jax_params``: the
  parameter names map one to one (the JAX stacked leaf ``stages.<key>``
  of ``n_stages`` rows is the port's ``stages.<i>.<key>``, one a stage),
  and each name's element count is the same on both sides.
"""

import dataclasses
import importlib
import importlib.util
import json
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import repro
from _env import REPO_ROOT, SUBPROC_ENV
from repro.configs import get_reduced as jax_get_reduced
from repro.core import bucketing as jax_bucketing
from repro.models import describe_params as jax_describe_params
from repro.models import param_count as jax_param_count
from repro_torch.configs import ARCH_NAMES, get_reduced

#: subpackage -> {name: why the port has it in another form}
OTHER_FORM = {
    "core": {
        "CollectiveStats": "reads HLO; the dry run counts collectives on fake DTensors "
                           "(launch/segments.py) and at the issue() seam",
        "SegmentCost": "reads HLO; the port's segment costs are launch/segments.py's SegCost",
        "parse_collectives": "reads HLO; the port counts collectives at the issue() seam, and "
                             "launch/profile_step.py gives the kernel classes",
        "segment_cost": "reads HLO; launch/segments.py counts a segment on fake DTensors",
    },
    "models": {
        "forward": "Transformer.forward",
        "init_params": "Transformer(cfg, seed=...) and its reset_parameters",
        "loss_fn": "Transformer.loss",
        "staged_loss_fns": "the hook-based dag step does not need it",
    },
    "kernels": {
        "flash_attention": "the subpackage keeps the name (chip_smoke.py imports it as a "
                           "module); its ops are flash_attention_fwd / _dq / _dkv",
        "rglru": "the subpackage keeps the name (chip_smoke.py imports it as a module); "
                 "its op is kernels.rglru.rglru",
    },
    "serving": {
        "sharded_decode_core": "wraps the step in shard_map; the port runs "
                               "serving/sharded.py make_sharded_decode_step inside the "
                               "engine's graph",
        "sharded_decode_fn": "wraps the step in shard_map; see sharded_decode_core",
    },
}
#: the Pallas entry points: the port's CUDA kernels sit behind the subpackages' ops
PALLAS_REASON = "a Pallas entry point; the port's CUDA kernel is behind the subpackage's op"
#: the JAX package's modules with no counterpart module in the port
OTHER_MODULES = {"compat": "shims JAX APIs across JAX versions; the port imports no JAX"}

SUBPACKAGES = ("core", "models", "kernels", "kernels.comm_pack", "kernels.flash_attention",
               "kernels.rglru", "kernels.rwkv6_wkv", "serving", "optim", "runtime", "planning",
               "fabric", "sim", "data", "checkpoint")


def other_form(sub: str, name: str) -> str | None:
    if name.endswith("_pallas"):
        return PALLAS_REASON
    return OTHER_FORM.get(sub, {}).get(name)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_name_resolves_or_has_another_form(sub):
    jax_mod = importlib.import_module(f"repro.{sub}")
    port = importlib.import_module(f"repro_torch.{sub}")
    missing = [n for n in jax_mod.__all__ if not hasattr(port, n) and other_form(sub, n) is None]
    assert not missing, f"repro_torch.{sub} lacks {missing}"
    for name in OTHER_FORM.get(sub, {}):
        assert name in jax_mod.__all__, (sub, name)  # the list names only real JAX names
    # a name the port has must be its own kind of thing: no module stands in for a function
    for name in jax_mod.__all__:
        if other_form(sub, name) is None:
            assert callable(getattr(port, name)) == callable(getattr(jax_mod, name)), (sub, name)


def test_every_jax_module_has_a_counterpart():
    names = {m.name for m in pkgutil.iter_modules(repro.__path__)}
    missing = [n for n in sorted(names) if n not in OTHER_MODULES
               and importlib.util.find_spec(f"repro_torch.{n}") is None]
    assert not missing, missing
    assert set(OTHER_MODULES) <= names


def test_core_aliases_are_the_jax_kinds():
    import repro.core as jcore
    import repro_torch.core as core
    from repro_torch.core import comm_model, cost_model

    assert isinstance(core.TPU_V5E, cost_model.Hardware)
    assert core.TPU_V5E_ICI is comm_model.TPU_V5E
    for ours, theirs in ((core.TPU_V5E, jcore.TPU_V5E), (core.TPU_V5E_ICI, jcore.TPU_V5E_ICI)):
        assert type(ours).__name__ == type(theirs).__name__
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert sorted(core.__all__) == sorted(n for n in jcore.__all__ if other_form("core", n) is None)


def test_importing_core_loads_no_trainer():
    script = (
        "import json, sys\n"
        "import repro_torch.core as core\n"
        "bare = sorted(m for m in sys.modules if m.startswith('repro_torch.core.'))\n"
        "core.mg_wfbp_schedule, core.TPU_V5E, core.tree_set, core.SyncConfig\n"
        "print(json.dumps({'bare': bare, 'trainer': 'repro_torch.core.trainer' in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, cwd=REPO_ROOT, env=SUBPROC_ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec == {"bare": [], "trainer": False}


def test_tree_set_matches_the_jax_tree_set():
    from repro_torch.core import tree_get, tree_set

    tree = {"a": [1, {"b": (2, 3)}], "c": {"d": [4, 5]}, "e": 6}
    for path, value in ((("a", 1, "b", 0), 7), (("c", "d", 1), [8]), (("a", 0), {"x": 9}),
                        (("e",), 10), ((), 11)):
        before = repr(tree)
        got = tree_set(tree, path, value)
        want = jax_bucketing.tree_set(tree, path, value)
        assert got == want and type(got) is type(want), path
        assert repr(tree) == before  # a new tree; the old one as it was
        if path:
            assert tree_get(got, path) == value
    with pytest.raises(TypeError):
        tree_set({"a": 1}, ("a", 0), 2)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_count_and_describe_params_match_jax(arch):
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models.transformer import init_params
    from repro_torch.models import (Transformer, describe_params, from_jax_params, load_arrays,
                                    param_count)

    jcfg = jax_get_reduced(arch, param_dtype=jnp.float32)
    tcfg = get_reduced(arch, param_dtype=torch.float32)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
    arrays = from_jax_params(params, tcfg)
    model = Transformer(tcfg, device="cpu", seed=None)
    load_arrays(model, arrays)
    named = dict(model.named_parameters())
    assert set(named) == set(arrays)
    for name, p in named.items():
        assert p.numel() == arrays[name].size, name
    want = jax_param_count(params)
    assert param_count(model) == param_count(arrays) == param_count(
        {n: torch.from_numpy(np.array(a)) for n, a in arrays.items()}) == want
    assert describe_params(tcfg, model) == jax_describe_params(jcfg, params)
