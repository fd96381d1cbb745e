"""Architecture registry.

``get_config(name)`` returns the full ArchConfig, ``get_reduced(name)`` a
small same-family variant for CPU tests; keyword overrides replace fields
of either, as the JAX registry's do.  The names are the JAX package's; the
eight token-input archs are ported, and ``musicgen-large`` and
``qwen2-vl-2b`` (embeds input, sinusoidal positions, M-RoPE) raise
``NotImplementedError`` until they are.  The JAX configs' MoE knobs
``moe_groups`` (dispatch groups per token shard, set by its launcher under
expert parallelism) and ``moe_token_chunk`` (a legacy field nothing reads)
are left out: the port routes every token as one group.
"""

from __future__ import annotations

import dataclasses
from importlib import import_module

from ..models.common import ArchConfig

_MODULES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "starcoder2-7b": "starcoder2_7b",
    "gemma2-2b": "gemma2_2b",
    "starcoder2-3b": "starcoder2_3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "dbrx-132b": "dbrx_132b",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

#: Every arch the JAX package registers; the ones outside ``_MODULES`` are
#: still to port.
ARCH_NAMES = (
    "musicgen-large",
    "tinyllama-1.1b",
    "starcoder2-7b",
    "gemma2-2b",
    "starcoder2-3b",
    "mixtral-8x7b",
    "dbrx-132b",
    "rwkv6-7b",
    "recurrentgemma-9b",
    "qwen2-vl-2b",
)
PORTED_ARCHS = tuple(_MODULES)


def _module(name: str):
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet; ported: {PORTED_ARCHS}"
        )
    return import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str, **overrides) -> ArchConfig:
    cfg = _module(name).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_reduced(name: str, **overrides) -> ArchConfig:
    cfg = _module(name).reduced()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
