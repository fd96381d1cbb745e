"""Step builders (counterpart of ``repro/launch/steps.py``): the train step
(loss, gradient, clipping, the optimizer), the prefill and the decode step.

Each takes the JAX builders' ``ShardingRules`` (``rules``, None for a
single device): with rules, the step runs under
``activation_sharding(from_rules(...))`` and hands the model the
between-stage and logits constraints, so on DTensor parameters (the dry
run's fake world, ``launch/dryrun.py``) every ``constrain`` site places
its tensor as the JAX step's ``with_sharding_constraint`` does.  Without
rules every site is the identity.

The trainer's ``core.trainer.TrainStep`` stays the training path (per-group
gradient sync, overlap, compression); ``make_train_step`` is the step the
dry run counts.  The steps take the model itself where the JAX steps take
its parameter tree, and update it and the optimizer state in place; the
serving steps run under ``torch.inference_mode()`` (``no_grad`` with
rules).
"""

from __future__ import annotations

import contextlib

import torch

from ..models.common import ArchConfig
from ..models.transformer import init_caches
from ..optim.optimizers import Optimizer, clip_by_global_norm
from ..parallel.context import activation_sharding, from_rules
from ..parallel.sharding import ShardingRules, act_constraint, logits_constraint


def _no_grad(rules: ShardingRules | None):
    """``inference_mode`` for the serving steps; with rules (DTensor
    parameters, which cannot be viewed under inference mode) ``no_grad``,
    the same computation."""
    return torch.inference_mode() if rules is None else torch.no_grad()


def _ctx(rules: ShardingRules | None, batch: int, prefer: str | None = None):
    if rules is None:
        return contextlib.nullcontext()
    if prefer is None:
        # EP archs reserve the model axis for experts; the dense parts
        # (attention) then need TP on that axis to stay parallel
        prefer = "tp" if rules.reserve_model else "fsdp"
    return activation_sharding(from_rules(rules, batch, prefer=prefer))


def _like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (FSDP: the
    reduce-scatter; DP over replicated data axes: the all-reduce)."""
    placements = getattr(p, "placements", None)
    if placements is None or tuple(g.placements) == tuple(placements):
        return g
    return g.redistribute(p.device_mesh, placements)


def make_train_step(
    cfg: ArchConfig,
    rules: ShardingRules | None,
    optimizer: Optimizer,
    *,
    lr: float = 3e-4,
    grad_clip: float = 1.0,
    n_microbatches: int = 1,
):
    """``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``.

    The loss (the model's ``loss``: CE plus the MoE aux) and its gradient
    per microbatch; with ``n_microbatches`` > 1 the batch splits along its
    rows, the gradients add up in f32 and are averaged, as the JAX step's
    scan does (the gradients then stay f32).  Then ``clip_by_global_norm``
    and the optimizer's in-place update.  A parameter the loss does not
    read gets a zero gradient, as under ``jax.grad``.  ``metrics`` holds
    the f32 ``loss`` and ``grad_norm``."""

    def loss_and_grads(model, batch):
        b = batch.get("tokens", batch.get("embeds"))
        micro_b = b.shape[0]  # per-microbatch rows: what the constraints shard
        params = list(model.parameters())
        # backward under the context too: a remat region recomputes there
        with _ctx(rules, micro_b):
            loss = model.loss(
                batch,
                act_sharding_constraint=None if rules is None else act_constraint(cfg, rules, micro_b),
                logits_sharding_constraint=None if rules is None else logits_constraint(cfg, rules, micro_b),
            )
            for p in params:
                p.grad = None
            loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        for p in params:
            p.grad = None
        return loss.detach(), [_like_param(g, p) for g, p in zip(grads, params)]

    def train_step(model, opt_state, batch):
        names = [n for n, _ in model.named_parameters()]
        if n_microbatches == 1:
            loss, grads = loss_and_grads(model, batch)
        else:
            rows = next(iter(batch.values())).shape[0] // n_microbatches
            acc, loss = None, torch.zeros((), dtype=torch.float32)
            for i in range(n_microbatches):
                micro = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l, g = loss_and_grads(model, micro)
                g = [x.float() for x in g]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                loss = loss + l
            grads = [a / n_microbatches for a in acc]
            loss = loss / n_microbatches
        grads, gnorm = clip_by_global_norm(dict(zip(names, grads)), grad_clip)
        optimizer.update(grads, opt_state, dict(model.named_parameters()), lr)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig, max_seq: int, cache_dtype=torch.bfloat16,
                      rules: ShardingRules | None = None):
    """``prefill(model, batch, caches=None) -> (last_logits (B, vocab) f32,
    caches)``.

    ``batch['tokens']`` (B, S), or ``batch['embeds']`` (B, S, d) f32 (which
    win when both are given, as in the JAX step), starts at position 0; the
    caches are a fresh ``init_caches(cfg, B, max_seq)`` tree on the input's
    device, in ``cache_dtype`` (bf16 by default, as the JAX step's), unless
    the caller hands a tree in (the dry run's placed caches); the forward
    fills them.  The head runs on the last row only.  With ``rules`` the
    prefill runs under ``prefer='tp'`` on EP archs and ``'seq_tp'``
    otherwise, as the JAX step."""

    def prefill(model, batch: dict, caches: dict | None = None):
        b = batch.get("tokens", batch.get("embeds"))
        prefer = "tp" if (rules is not None and rules.reserve_model) else "seq_tp"
        with _no_grad(rules), _ctx(rules, b.shape[0], prefer=prefer):
            if caches is None:
                caches = init_caches(cfg, b.shape[0], max_seq, dtype=cache_dtype, device=b.device)
            logits, caches, _ = model(
                batch.get("tokens"), caches, last_only=True, embeds=batch.get("embeds"),
                act_sharding_constraint=None if rules is None else act_constraint(cfg, rules, b.shape[0]),
            )
        return logits[:, -1], caches

    return prefill


def make_decode_step(cfg: ArchConfig, rules: ShardingRules | None = None):
    """``decode(model, caches, batch, pos) -> (logits (B, vocab) f32, caches)``.

    ``batch['tokens']`` (B, 1) holds one token per row, or
    ``batch['embeds']`` (B, 1, d) one embedding, all at the absolute
    position ``pos`` (an int or a 0-d device tensor; per-row positions are
    the serving engine's, layered above this step).  The caches are
    updated in place and returned.  Sinusoidal positions follow the JAX
    forward's rule (``models.transformer``): at ``pos`` for an int, at 0 for
    a tensor, as under the JAX step's ``jit``.  With ``rules`` the step
    runs under ``prefer='fsdp'`` (the caches carry the TP)."""

    def decode(model, caches: dict, batch: dict, pos):
        b = batch.get("tokens", batch.get("embeds"))
        with _no_grad(rules), _ctx(rules, b.shape[0], prefer="fsdp"):
            logits, caches, _ = model(batch.get("tokens"), caches, pos, embeds=batch.get("embeds"))
        return logits[:, 0], caches

    return decode
