"""Serving step builders (counterpart of ``repro/launch/steps.py``'s
``make_prefill_step`` and ``make_decode_step``).

The JAX package's third builder, ``make_train_step``, has its counterpart
in ``core/trainer.py``.  Nothing here shards: the JAX builders' sharding
rules are ``serving/sharded.py``'s placements, and its decode step wraps
``make_decode_step``.  Both steps run under ``torch.inference_mode()`` and
take the model itself where the JAX steps take its parameter tree.
"""

from __future__ import annotations

import torch

from ..models.common import ArchConfig
from ..models.transformer import init_caches


def make_prefill_step(cfg: ArchConfig, max_seq: int, cache_dtype=torch.bfloat16):
    """``prefill(model, batch) -> (last_logits (B, vocab) f32, caches)``.

    ``batch['tokens']`` (B, S), or ``batch['embeds']`` (B, S, d) f32 (which
    win when both are given, as in the JAX step), starts at position 0; the
    caches are a fresh ``init_caches(cfg, B, max_seq)`` tree on the input's
    device, in ``cache_dtype`` (bf16 by default, as the JAX step's), filled
    by the forward.  The head runs on the last row only."""

    def prefill(model, batch: dict):
        b = batch.get("tokens", batch.get("embeds"))
        with torch.inference_mode():
            caches = init_caches(cfg, b.shape[0], max_seq, dtype=cache_dtype, device=b.device)
            logits, caches, _ = model(batch.get("tokens"), caches, last_only=True,
                                      embeds=batch.get("embeds"))
        return logits[:, -1], caches

    return prefill


def make_decode_step(cfg: ArchConfig):
    """``decode(model, caches, batch, pos) -> (logits (B, vocab) f32, caches)``.

    ``batch['tokens']`` (B, 1) holds one token per row, or
    ``batch['embeds']`` (B, 1, d) one embedding, all at the absolute
    position ``pos`` (an int or a 0-d device tensor; per-row positions are
    the serving engine's, layered above this step).  The caches are
    updated in place and returned.  Sinusoidal positions follow the JAX
    forward's rule (``models.transformer``): at ``pos`` for an int, at 0 for
    a tensor, as under the JAX step's ``jit``."""

    def decode(model, caches: dict, batch: dict, pos):
        with torch.inference_mode():
            logits, caches, _ = model(batch.get("tokens"), caches, pos, embeds=batch.get("embeds"))
        return logits[:, 0], caches

    return decode
