"""The policy registries of both packages, held at what they were before
any test ran.

``tests/test_planning.py`` registers a policy (``_test_pairs``) into the
JAX package's registry and leaves it there; a port test that compares the
two registries, or sweeps every registered policy, would then see one more
policy on the JAX side whenever that file ran first in the same process.
Importing ``pristine_policy_registries`` into a test module applies it to
every test there: it snapshots ``_POLICIES`` and ``_ALIASES`` of both
registries when this module is first imported (at collection, before any
test runs) and puts that snapshot back, through ``monkeypatch``, around
each test.
"""

from __future__ import annotations

import pytest

from repro.planning import registry as jax_registry
from repro_torch.planning import registry as torch_registry

_SNAPSHOT = {mod: (dict(mod._POLICIES), dict(mod._ALIASES))
             for mod in (jax_registry, torch_registry)}


@pytest.fixture(autouse=True)
def pristine_policy_registries(monkeypatch):
    """Both registries as they were at collection, for this test only."""
    for mod, (policies, aliases) in _SNAPSHOT.items():
        monkeypatch.setattr(mod, "_POLICIES", dict(policies))
        monkeypatch.setattr(mod, "_ALIASES", dict(aliases))
