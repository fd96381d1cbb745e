"""``core/bucketing.py``'s per-leaf and synthetic layouts against the JAX
package's, and the device ``psum_time_fn`` times on.

* ``layout_for_stacked_lm`` equals the JAX layout field for field.
* ``layout_from_params`` over a nested dict equals the JAX layout of the
  same dict of arrays unit for unit, with and without ``order_key`` and
  ``model_shards``; over an ``nn.Module`` it is the JAX layout of the
  module's parameters nested at their dots, in registration order.
* ``psum_time_fn`` resolves its device as every entry point does: CUDA
  unless the caller asks for the CPU, raising when CUDA is missing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import bucketing as jax_bucketing
from repro_torch.configs import get_reduced
from repro_torch.core import bucketing
from repro_torch.models import Transformer
from repro_torch.planning import tuner


def _units(layout) -> list[dict]:
    return [dataclasses.asdict(u) for u in layout.units]


def _tree(rng) -> dict:
    """A nested dict of f32 arrays, keys out of sorted order at each level."""
    shapes = {"head": (7, 3), "embed": (11, 7),
              "blocks": {"b": {"w": (7, 5), "bias": (5,)}, "a": {"w": (5, 7), "scale": ()}}}

    def draw(x):
        if isinstance(x, dict):
            return {k: draw(v) for k, v in x.items()}
        return rng.standard_normal(x).astype(np.float32)

    return draw(shapes)


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


@pytest.mark.parametrize("args", [(4, 5000, 3000, 7000), (6, 1e6, 1e6, 1e6)])
def test_layout_for_stacked_lm_equals_jax(args):
    for kw in ({}, {"comm_dtype_bytes": 2, "model_shards": 4}):
        assert _units(bucketing.layout_for_stacked_lm(*args, **kw)) == \
            _units(jax_bucketing.layout_for_stacked_lm(*args, **kw))


@pytest.mark.parametrize("order", [None, "by_length"])
@pytest.mark.parametrize("model_shards", [1, 3])
def test_layout_from_params_equals_jax(order, model_shards):
    arrays = _tree(np.random.default_rng(0))
    key = None if order is None else (lambda name: (len(name), name))
    want = jax_bucketing.layout_from_params(arrays, model_shards=model_shards, order_key=key)
    got = bucketing.layout_from_params(_map(torch.from_numpy, arrays),
                                       model_shards=model_shards, order_key=key)
    assert _units(got) == _units(want)
    assert [u.name for u in got.units][:2] == (["head", "embed"] if order else
                                              ["blocks.a.scale", "blocks.a.w"])


def test_layout_from_a_module_is_its_parameters_in_registration_order():
    model = Transformer(get_reduced("tinyllama-1.1b"), device="meta", seed=None)
    names = [n for n, _ in model.named_parameters()]
    nested: dict = {}
    for n, p in model.named_parameters():
        *parents, leaf = n.split(".")
        node = nested
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.empty(tuple(p.shape), np.float32)
    got = bucketing.layout_from_params(model, comm_dtype_bytes=2)
    want = jax_bucketing.layout_from_params(nested, comm_dtype_bytes=2,
                                            order_key=names.index)
    assert [u.name for u in got.units] == names
    assert _units(got) == _units(want)


def test_psum_time_fn_resolves_its_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tuner.psum_time_fn()
    tuner.psum_time_fn(device="cpu")  # asked for: no error
    seen = []
    real = tuner.resolve_device
    monkeypatch.setattr(tuner, "resolve_device", lambda d=None: seen.append(real(d)) or seen[-1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tuner.psum_time_fn()  # nothing is allocated before the first call
    assert seen == [torch.device("cuda")]
