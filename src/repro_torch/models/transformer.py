"""Decoder-only LM over block patterns (counterpart of
``repro/models/transformer.py``): dense ``('attn',)`` stacks, Gemma2's
alternating ``('attn_local', 'attn_global')``, the MoE ``('moe',)`` stacks,
the Griffin hybrid of ``'rec'`` (RG-LRU) and ``'attn_local'`` sublayers,
and RWKV6's ``('rwkv',)`` stack.

Parameters are held per layer, so that a gradient hook fires per layer::

    embed                       (vocab, d)  f32
    stages.<i>.<kind>_<j>.norm{1,2}.scale         (.bias too for layernorm)
    stages.<i>.<kind>_<j>.post_norm{1,2}.scale    (post_norm archs: gemma2)
    stages.<i>.attn_0.attn.{wq,wk,wv,wo}          ('attn*' / 'moe'; q_norm, k_norm
                                                   (hd,) too with qk_norm)
    stages.<i>.rec_0.mix.{w_main,w_gate,conv_w,conv_b,wa,ba,wx,bx,lam,w_out}
    stages.<i>.<kind>_<j>.mlp.{w_gate,w_up,w_down}   (no w_gate for mlp='gelu')
    stages.<i>.moe_0.moe.{router,w_gate,w_up,w_down} ('moe': no mlp; router f32)
    stages.<i>.rwkv_0.{ln1,ln2,tm,cm}....         ('rwkv': the whole block,
                                                   no norm1/norm2/mlp)
    tail.<kind>_<j>....         like one stage, for ``tail_pattern``
    final_norm.scale            (.bias too for layernorm)
    head                        (d, vocab)  param_dtype; absent when tied

The JAX package stacks ``stages`` on a leading ``n_stages`` axis
(``params['stages']['attn_0']['attn']['wq']`` is ``(n_stages, d, qd)``);
``tail`` is not stacked.  ``param_shapes`` gives the port's parameters in
that stacked shape tree, which is what the planning layout is built over,
and ``from_jax_params`` / ``to_jax_params`` convert numpy weights between
the two forms.

Input: token ids (``input_mode='tokens'``) are looked up in ``embed``;
``embeds`` (B, S, d) floats (``input_mode='embeds'``: MusicGen, Qwen2-VL,
whose frontends are stubs) are cast to ``param_dtype`` and ``embed`` is not
read (untied, the training loss gives it no gradient; the trainer makes that
an exact zero).  With ``Attention.rope == 'sinusoidal'`` the f32 sinusoid
table is cast to the activations' dtype and added, at the rows of positions
``q_offset ..`` when ``q_offset`` is an int and at positions ``0 ..`` when it
is a tensor: the JAX forward's rule (``pos0 = q_offset if isinstance(q_offset,
int) else 0``), under which its jitted decode step, whose offset is traced,
adds position 0's row at every step.  The engine's decode step passes a
device tensor, so it reproduces the JAX engine.  ``'mrope'`` positions are
(3, B, S), the three streams equal (text).

Tied embeddings (gemma): the head is ``embed.T`` cast to ``param_dtype``
once per step, and the embedding output is scaled by ``sqrt(d)``.  At a
vocab of 64k or more and a sequence longer than (and a multiple of) 512
tokens the loss runs per 512-token chunk under activation checkpointing,
so the (B, S, vocab) f32 logits are never held whole.  ``logit_softcap``
(gemma2) caps the f32 logits on both paths, inside the chunks.

The loss is the JAX ``loss_fn``'s ``ce + MOE_AUX_COEF * aux``, where
``aux`` sums the MoE layers' load-balance terms (0 without MoE layers).
Each sublayer returns ``(x, aux)`` out of its ``torch.utils.checkpoint``
region; the recomputation in backward discards its outputs, so each
layer's aux is counted once.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..devices import resolve_device
from .common import ArchConfig, param_count
from .layers import (
    KPOS_EMPTY,
    MLP,
    MLPS,
    NORMS,
    ROPES,
    AttentionBlock,
    LayerNorm,
    make_norm,
    sinusoidal_embedding,
    softcap_logits,
)
from .moe import MoEBlock
from .rglru import RGLRUBlock, init_rglru_state, lam_init
from .rwkv6 import LORA_DECAY, LORA_MIX, RWKV6Block, init_rwkv6_state

KINDS = ("attn", "attn_local", "attn_global", "moe", "rec", "rwkv")
REMATS = ("full", "dots", "none")
ATTN_KINDS = ("attn", "attn_local", "attn_global", "moe")  # the kinds with an attention block
CHUNKED_CE_VOCAB = 64000  # big-vocab archs never materialize full logits
CE_SEQ_CHUNK = 512
MOE_AUX_COEF = 0.01


def _check_supported(cfg: ArchConfig) -> None:
    kinds = set(cfg.pattern) | set(cfg.tail_pattern)
    att = cfg.attention
    rec_kind = None if cfg.recurrent is None else cfg.recurrent.kind
    unsupported = {
        "pattern": not kinds <= set(KINDS),
        "recurrent": ("rec" in kinds and rec_kind != "rglru")
                     or ("rwkv" in kinds and rec_kind != "rwkv6"),
        "norm": cfg.norm not in NORMS,
        # an 'rwkv' block carries its own channel mix; every other kind an MLP
        "mlp": cfg.mlp not in MLPS if kinds - {"rwkv"} else cfg.mlp != "rwkv_cmix",
        "attention": bool(kinds & set(ATTN_KINDS)) and cfg.attention is None,
        "moe": "moe" in kinds and cfg.moe is None,
        "remat": cfg.remat not in REMATS,
        "input_mode": cfg.input_mode not in ("tokens", "embeds"),
        "rope": att is not None and att.rope not in ROPES,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: options not ported yet: {bad}")


def window_for(cfg: ArchConfig, kind: str) -> int | None:
    """The attention window of a ``kind`` sublayer (the JAX ``_window_for``):
    ``local_window`` for ``'attn_local'``, ``attention.window`` for
    ``'attn'`` and ``'moe'``, else None (every key)."""
    if kind == "attn_local":
        return cfg.local_window
    if kind in ("attn", "moe") and cfg.attention and cfg.attention.window:
        return cfg.attention.window
    return None


class SubLayer(nn.Module):
    """One sublayer: pre-norm attention (every ``ATTN_KINDS`` kind, over
    ``window_for`` keys) or pre-norm RG-LRU block (``'rec'``, held as
    ``mix``), then a pre-norm MLP, or the MoE FFN for ``'moe'``; with
    ``cfg.post_norm`` each branch's output is normed before the residual
    add.  ``forward(x, positions, cache=None, q_offset=0)`` returns ``(x,
    aux, new_cache)``: aux is the MoE block's load-balance term, None for
    the other kinds; new_cache is the sublayer's KV cache or decode state,
    written in place (None without one)."""

    def __init__(self, cfg: ArchConfig, kind: str, device=None):
        super().__init__()
        self.norm1 = make_norm(cfg, device)
        self.norm2 = make_norm(cfg, device)
        if cfg.post_norm:
            self.post_norm1 = make_norm(cfg, device)
            self.post_norm2 = make_norm(cfg, device)
        if kind == "rec":
            self.mix = RGLRUBlock(cfg, device)
        else:
            self.attn = AttentionBlock(cfg, cfg.attention, device, window=window_for(cfg, kind))
        if kind == "moe":
            self.moe = MoEBlock(cfg, device)
        else:
            self.mlp = MLP(cfg, device)
        self.kind, self.post_norm = kind, cfg.post_norm

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cache=None,
                q_offset: torch.Tensor | int = 0):
        h = self.norm1(x)
        if self.kind == "rec":
            h, new_cache = self.mix(h, cache)
        else:
            h, new_cache = self.attn(h, positions, cache, q_offset)
        if self.post_norm:
            h = self.post_norm1(h)
        x = x + h
        h = self.norm2(x)
        aux = None
        if self.kind == "moe":
            h, aux = self.moe(h)
        else:
            h = self.mlp(h)
        if self.post_norm:
            h = self.post_norm2(h)
        return x + h, aux, new_cache


# remat='dots' is the JAX model's ``dots_with_no_batch_dims_saveable``: the
# output of a product whose contraction has no batch dimension is saved for
# backward, everything else is recomputed.  In the port such a product is
# aten.mm (aten.addmm with a bias): an ``x @ w`` of a (B, S, .) activation
# by a 2D weight folds the leading dims into one mm.  These are q / k / v /
# o, the MLPs' gate / up / down, the MoE router, the RG-LRU block's
# main / gate / out and its wa / wx gates, RWKV6's r / k / v / g / o,
# lora_a, decay_a / decay_b and the channel mix's k / r / v, and the M-RoPE
# angles.  The JAX products with a batch dimension lower to aten.bmm and
# are recomputed: attention scores and PV, the MoE dispatch / expert /
# combine einsums, RWKV6's lora_b einsum and its WKV chunk products.  No
# bmm is saved, since torch.einsum lowers a batch of one (one MoE group,
# one KV head at batch 1) to a bmm as well.  On the card the flash, RG-LRU
# and WKV kernels write through ctypes into buffers that no dispatch mode
# sees, so they rerun, as under 'full'.  One product is saved that JAX
# does not keep: an MLP's down projection without a post-norm, which only
# the residual add reads, so JAX's partial evaluation drops it (one (B, S, d)
# tensor a layer more; ROADMAP C).
SAVED_PRODUCTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of ``remat='dots'``."""
    if op in SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def dots_contexts():
    """``checkpoint``'s ``context_fn`` under ``remat='dots'``."""
    return create_selective_checkpoint_contexts(dots_policy)


def run_sublayer(sub: nn.Module, x: torch.Tensor, positions: torch.Tensor, remat: str):
    """``(x, aux)`` of one sublayer in training (no cache) under the
    ``remat`` policy: ``'full'`` recomputes the sublayer in backward
    (``torch.utils.checkpoint``), ``'dots'`` keeps its ``dots_policy``
    products and recomputes the rest, ``'none'`` keeps what autograd
    saves.  aux is None for a sublayer without MoE."""
    if remat == "none":
        out = sub(x, positions)
    elif remat == "dots":
        out = checkpoint(sub, x, positions, use_reentrant=False, context_fn=dots_contexts)
    elif remat == "full":
        out = checkpoint(sub, x, positions, use_reentrant=False)
    else:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
    return out[0], out[1]


def _sublayer(cfg: ArchConfig, kind: str, device) -> nn.Module:
    return RWKV6Block(cfg, device) if kind == "rwkv" else SubLayer(cfg, kind, device)


def _sublayers(cfg: ArchConfig, pattern: tuple[str, ...], device) -> nn.ModuleDict:
    return nn.ModuleDict({f"{kind}_{i}": _sublayer(cfg, kind, device) for i, kind in enumerate(pattern)})


@functools.cache
def _constant(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # a 0-d tensor made once per device: a CUDA graph captured later copies nothing from the
    # host.  Made outside inference mode, so training may save it for backward after serving
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=dtype, device=device)


class Transformer(nn.Module):
    """The LM, on ``device`` (cuda when None, see ``resolve_device``).
    ``seed`` draws the initial weights with a ``torch.Generator`` on that
    device (truncated normals, as the JAX package's ``init_params`` draws
    them, though not the same numbers)."""

    def __init__(self, cfg: ArchConfig, device: torch.device | str | None = None,
                 seed: int | None = 0):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, dtype=torch.float32, device=device))
        self.stages = nn.ModuleList(_sublayers(cfg, cfg.pattern, device) for _ in range(cfg.n_stages))
        if cfg.tail_pattern:
            self.tail = _sublayers(cfg, cfg.tail_pattern, device)
        self.final_norm = make_norm(cfg, device)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(
                torch.empty(cfg.d_model, cfg.vocab, dtype=cfg.param_dtype, device=device))
        if seed is not None and device.type != "meta":
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator(device=self.embed.device).manual_seed(seed)
        cfg, att = self.cfg, self.cfg.attention

        def tn(p: torch.Tensor, std: float) -> None:
            x = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
            p.copy_((x * std).to(p.dtype))

        def reset_norm(norm: nn.Module) -> None:
            norm.scale.fill_(0.0 if cfg.norm == "rmsnorm_gemma" else 1.0)
            if isinstance(norm, LayerNorm):
                norm.bias.zero_()

        tn(self.embed, 1.0)
        d = cfg.d_model
        for sub in self.sublayers():
            if sub.kind == "rwkv":  # the stds of the JAX package's init_rwkv6_block
                tm, cm = sub.tm, sub.cm
                for w in (tm.lora_a, tm.w_r, tm.w_k, tm.w_v, tm.w_g, tm.w_o, tm.decay_a,
                          cm.w_k, cm.w_r):
                    tn(w, d ** -0.5)
                tn(tm.lora_b, LORA_MIX ** -0.5)
                tn(tm.decay_b, LORA_DECAY ** -0.5)
                tn(cm.w_v, cfg.d_ff ** -0.5)
                for z in (tm.mu_x, tm.mu_rkvwg, tm.u, cm.mu_k, cm.mu_r):
                    z.zero_()
                tm.decay_base.fill_(-1.0)
                tm.gn_scale.fill_(1.0)
                reset_norm(sub.ln1)
                reset_norm(sub.ln2)
                continue
            if sub.kind == "rec":
                m = sub.mix
                w, cw = m.wa.shape[0], m.conv_w.shape[0]
                tn(m.w_main, d ** -0.5)
                tn(m.w_gate, d ** -0.5)
                tn(m.conv_w, cw ** -0.5)
                tn(m.wa, w ** -0.5)
                tn(m.wx, w ** -0.5)
                tn(m.w_out, w ** -0.5)
                for z in (m.conv_b, m.ba, m.bx):
                    z.zero_()
                m.lam.copy_(lam_init(w, m.lam.device))
            else:
                for w in (sub.attn.wq, sub.attn.wk, sub.attn.wv):
                    tn(w, d ** -0.5)
                tn(sub.attn.wo, (att.n_heads * att.head_dim) ** -0.5)
                if att.qk_norm:
                    sub.attn.q_norm.fill_(1.0)
                    sub.attn.k_norm.fill_(1.0)
            if sub.kind == "moe":  # the stds of the JAX package's init_moe
                for w in (sub.moe.router, sub.moe.w_gate, sub.moe.w_up):
                    tn(w, d ** -0.5)
                tn(sub.moe.w_down, cfg.d_ff ** -0.5)
            else:
                if cfg.mlp != "gelu":
                    tn(sub.mlp.w_gate, d ** -0.5)
                tn(sub.mlp.w_up, d ** -0.5)
                tn(sub.mlp.w_down, cfg.d_ff ** -0.5)
            for norm in (sub.norm1, sub.norm2) + ((sub.post_norm1, sub.post_norm2)
                                                 if cfg.post_norm else ()):
                reset_norm(norm)
        reset_norm(self.final_norm)
        if not cfg.tie_embeddings:
            tn(self.head, d ** -0.5)

    def sublayers(self) -> list[nn.Module]:
        """Every sublayer in forward order: the stages', then the tail's."""
        subs = [sub for stage in self.stages for sub in stage.values()]
        if self.cfg.tail_pattern:
            subs += list(self.tail.values())
        return subs

    def _embed(self, tokens: torch.Tensor | None, embeds: torch.Tensor | None,
               q_offset: torch.Tensor | int) -> torch.Tensor:
        cfg = self.cfg
        if embeds is not None:  # embeds win over tokens, as in the JAX forward
            x = embeds.to(cfg.param_dtype)
        elif tokens is None:
            raise ValueError("the forward needs token ids or embeds")
        else:
            x = nn.functional.embedding(tokens, self.embed).to(cfg.param_dtype)
            if cfg.tie_embeddings:  # gemma scaling
                x = x * _constant(cfg.d_model ** 0.5, cfg.param_dtype, x.device)
        if cfg.attention is not None and cfg.attention.rope == "sinusoidal":
            # the JAX rule: a traced (here: tensor) offset places the rows at 0
            pos0 = q_offset if isinstance(q_offset, int) else 0
            pe = sinusoidal_embedding(x.shape[1], cfg.d_model, pos0, x.device)
            x = x + pe.to(x.dtype)[None]
        return x

    def forward(self, tokens: torch.Tensor | None = None, caches: dict | None = None,
                q_offset: torch.Tensor | int = 0, *, last_only: bool = False,
                embeds: torch.Tensor | None = None, act_sharding_constraint=None):
        """The serving forward (the JAX ``forward`` with ``caches``):
        ``(logits f32, new_caches, aux)``, ``hidden`` plus the head.

        ``tokens`` (B, S) int, or ``embeds`` (B, S, d) float, start at
        absolute position ``q_offset`` (an int, or a 0-d device tensor in a
        decode step); ``caches`` is an ``init_caches`` tree, which every
        sublayer updates in place, so ``new_caches`` is ``caches`` itself
        (None without caches).  A prefill (S > 1) starts at 0; a decode step
        feeds one token per row.  With ``last_only`` the head runs on the
        last row only (the prefill's (B, 1, vocab) logits; the JAX prefill
        computes all rows and keeps the last).  ``act_sharding_constraint``
        is ``hidden``'s."""
        cfg = self.cfg
        x, aux = self.hidden(tokens, caches, q_offset, embeds=embeds,
                             act_sharding_constraint=act_sharding_constraint)
        if last_only:
            x = x[:, -1:]
        head = self.embed.T.to(cfg.param_dtype) if cfg.tie_embeddings else self.head
        logits = softcap_logits((x @ head).float(), cfg.logit_softcap)
        return logits, caches, aux

    def named_sublayers(self) -> list[tuple[tuple, nn.Module]]:
        """``sublayers()`` with where each sits in the cache tree:
        ``('stages', i, key)`` or ``('tail', key)``."""
        out = [(("stages", i, key), sub) for i, stage in enumerate(self.stages)
               for key, sub in stage.items()]
        if self.cfg.tail_pattern:
            out += [(("tail", key), sub) for key, sub in self.tail.items()]
        return out

    def hidden(self, tokens: torch.Tensor | None = None, caches: dict | None = None,
               q_offset: torch.Tensor | int = 0, *, embeds: torch.Tensor | None = None,
               act_sharding_constraint=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Final-norm hidden states (B, S, d) of the token (or embeds) batch,
        and the MoE aux summed over the layers (an f32 scalar, 0 without
        MoE).  With ``caches`` (serving, see ``forward``) every sublayer
        reads and updates its cache in place; without them (training) each
        runs under ``cfg.remat`` (``run_sublayer``) when gradients are on.
        ``act_sharding_constraint`` (a callable x -> x,
        ``parallel.sharding.act_constraint``'s) is applied to the input of
        every stage and of the tail, as in the JAX forward."""
        cfg = self.cfg
        x = self._embed(tokens, embeds, q_offset)
        B, S = x.shape[:2]
        positions = (torch.arange(S, device=x.device) + q_offset)[None, :].expand(B, S)
        if cfg.attention is not None and cfg.attention.rope == "mrope":
            positions = positions[None].expand(3, B, S)  # (t, h, w), equal for text
        remat = cfg.remat if caches is None and torch.is_grad_enabled() else "none"
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for where, sub in self.named_sublayers():
            if act_sharding_constraint is not None and _starts_stage(cfg, where):
                x = act_sharding_constraint(x)
            if caches is None:
                x, a = run_sublayer(sub, x, positions, remat)
            else:
                x, a, _ = sub(x, positions, layer_cache(caches, where), q_offset)
            if a is not None:
                aux = aux + a
        return self.final_norm(x), aux

    def loss(self, batch: dict[str, torch.Tensor], *, act_sharding_constraint=None,
             logits_sharding_constraint=None) -> torch.Tensor:
        """Mean next-token cross-entropy plus ``MOE_AUX_COEF`` x the MoE aux
        (the JAX package's ``loss_fn``), over ``batch['tokens']`` or, when
        the batch has no tokens, ``batch['embeds']``.  The two constraints
        (None: none) are the JAX ``loss_fn``'s: ``hidden``'s between stages,
        and one on the f32 logits (``ce_from_hidden``)."""
        x, aux = self.hidden(batch.get("tokens"), embeds=batch.get("embeds"),
                             act_sharding_constraint=act_sharding_constraint)
        # tied: cast once per step, outside the checkpointed loss chunks
        head = self.embed.T.to(self.cfg.param_dtype) if self.cfg.tie_embeddings else self.head
        ce = ce_from_hidden(self.cfg, head, x, batch["targets"], logits_sharding_constraint)
        return ce + MOE_AUX_COEF * aux


# ---------------------------------------------------------------------------
# Serving: KV caches and decode states
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    """``fn`` over the tensor leaves of a cache tree (dicts and tuples),
    dict keys in sorted order, as ``jax.tree.map`` visits them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensor leaves of a cache tree, in ``tree_map``'s order."""
    out: list[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def _starts_stage(cfg: ArchConfig, where: tuple) -> bool:
    """Whether the sublayer at ``where`` (``named_sublayers``) is the first
    of its stage or of the tail."""
    pattern = cfg.pattern if where[0] == "stages" else cfg.tail_pattern
    return where[-1] == f"{pattern[0]}_0"


def layer_cache(caches: dict, where: tuple):
    """One sublayer's cache: views into the stacked ``caches['stages']``
    leaves at stage ``where[1]``, or the tail's own; writes to them land in
    ``caches``."""
    if where[0] == "stages":
        return tree_map(lambda a: a[where[1]], caches["stages"][where[2]])
    return caches["tail"][where[1]]


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                device=None) -> dict:
    """Empty decode caches for every stage (and the tail), in the JAX
    package's tree: ``{'stages': {key: leaves stacked on a leading n_stages
    axis}, 'tail': {key: ...}}``.  An attention kind holds ``(k, v, kpos)``:
    k and v (batch, T, Hkv, hd) in ``dtype``, T = ``min(max_seq, window)``
    for a windowed kind, else ``max_seq``, and kpos (T,) int32 at
    ``KPOS_EMPTY``; ``'rec'`` holds ``init_rglru_state``, ``'rwkv'``
    ``init_rwkv6_state``.  On ``device`` (cuda when None, see
    ``resolve_device``)."""
    device = resolve_device(device)
    att = cfg.attention

    def cache_for(kind: str):
        if kind == "rwkv":
            return init_rwkv6_state(cfg, batch, device)
        if kind == "rec":
            return init_rglru_state(cfg, batch, device)
        window = window_for(cfg, kind)
        T = min(max_seq, window) if window else max_seq
        shape = (batch, T, att.n_kv_heads, att.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device),
                torch.full((T,), KPOS_EMPTY, dtype=torch.int32, device=device))

    stack = lambda a: a.unsqueeze(0).expand(cfg.n_stages, *a.shape).contiguous()
    out = {"stages": {f"{kind}_{i}": tree_map(stack, cache_for(kind))
                      for i, kind in enumerate(cfg.pattern)}}
    if cfg.tail_pattern:
        out["tail"] = {f"{kind}_{i}": cache_for(kind) for i, kind in enumerate(cfg.tail_pattern)}
    return out


def _token_nll(head: torch.Tensor, x: torch.Tensor, targets: torch.Tensor,
               cap: float | None, constrain=None, chunked: bool = False) -> torch.Tensor:
    logits = (x @ head).float()
    if constrain is not None and chunked:  # the JAX order: before the cap in a chunk
        logits = constrain(logits)
    logits = softcap_logits(logits, cap)
    if constrain is not None and not chunked:  # and after it on the whole sequence
        logits = constrain(logits)
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, targets[..., None].long())[..., 0]


def _chunk_nll(head: torch.Tensor, x: torch.Tensor, targets: torch.Tensor,
               cap: float | None, constrain=None) -> torch.Tensor:
    return torch.sum(_token_nll(head, x, targets, cap, constrain, chunked=True))


def ce_from_hidden(cfg: ArchConfig, head: torch.Tensor, x: torch.Tensor,
                   targets: torch.Tensor, logits_sharding_constraint=None) -> torch.Tensor:
    """Mean cross-entropy from the final-norm hidden states (the JAX
    package's ``_ce_from_hidden``, unmasked).  ``head`` is (d, vocab);
    ``logits_sharding_constraint`` (None: none) is applied to the f32
    logits where the JAX function applies it.

    Chunked path (vocab >= 64k, sequence a multiple of 512 and longer): the
    loss is summed per 512-token chunk, each under activation checkpointing,
    so only one chunk's (B, 512, vocab) f32 logits exist at a time, in the
    forward and again in backward."""
    B, seq = targets.shape
    con = logits_sharding_constraint
    if cfg.vocab >= CHUNKED_CE_VOCAB and seq > CE_SEQ_CHUNK and seq % CE_SEQ_CHUNK == 0:
        parts = [
            checkpoint(_chunk_nll, head, x[:, c : c + CE_SEQ_CHUNK],
                       targets[:, c : c + CE_SEQ_CHUNK], cfg.logit_softcap, con,
                       use_reentrant=False)
            for c in range(0, seq, CE_SEQ_CHUNK)
        ]
        return torch.sum(torch.stack(parts)) / (B * seq)
    return torch.mean(_token_nll(head, x, targets, cfg.logit_softcap, con))


# ---------------------------------------------------------------------------
# The stacked shape tree and the weight bridge
# ---------------------------------------------------------------------------


def _set(tree: dict, keys: list[str], value: Any) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _flatten(tree: Any, prefix: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _nest(named: dict[str, Any], stack) -> dict:
    """Per-layer names -> the stacked tree; ``stack`` joins one leaf's
    per-layer values along a new leading axis."""
    tree: dict = {}
    per_layer: dict[str, dict[int, Any]] = {}
    for name, v in named.items():
        parts = name.split(".")
        if parts[0] == "stages":
            per_layer.setdefault(".".join(parts[2:]), {})[int(parts[1])] = v
        else:
            _set(tree, parts, v)
    for rest, by_layer in per_layer.items():
        _set(tree, ["stages", *rest.split(".")], stack([by_layer[i] for i in range(len(by_layer))]))
    return tree


def describe_params(cfg: ArchConfig, params: Any) -> str:
    """One line on the model's size, as the JAX ``describe_params`` prints
    it; ``params`` a module or a tree of tensors (``param_count``)."""
    n = param_count(params)
    return f"{cfg.name}: {n / 1e9:.3f}B params ({cfg.n_layers} layers, d={cfg.d_model})"


def param_shapes(cfg: ArchConfig) -> dict:
    """The stacked shape tree, leaves as meta tensors (no memory)."""
    meta = Transformer(cfg, device="meta", seed=None)
    named = {n: p for n, p in meta.named_parameters()}
    return _nest(
        named,
        lambda ps: torch.empty((len(ps), *ps[0].shape), dtype=ps[0].dtype, device="meta"),
    )


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy knows bfloat16 only once a package (ml_dtypes) registered it
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_params(np_tree: dict, cfg: ArchConfig) -> dict[str, np.ndarray]:
    """The JAX package's stacked parameter tree (numpy leaves) -> numpy
    arrays keyed by this package's per-layer parameter names."""
    out = {}
    for path, leaf in _flatten(np_tree):
        leaf = np.asarray(leaf)
        if path[0] == "stages":
            if leaf.shape[0] != cfg.n_stages:
                raise ValueError(f"{path}: {leaf.shape[0]} stages, config has {cfg.n_stages}")
            for i in range(cfg.n_stages):
                out[f"stages.{i}." + ".".join(path[1:])] = leaf[i]
        else:
            out[".".join(path)] = leaf
    return out


def to_jax_params(module: nn.Module) -> dict:
    """The module's parameters as the JAX package's stacked tree of numpy
    arrays."""
    named = {n: _to_numpy(p) for n, p in module.named_parameters()}
    return _nest(named, lambda xs: np.stack(xs, axis=0))


@torch.no_grad()
def load_arrays(module: nn.Module, arrays: dict[str, np.ndarray]) -> None:
    """Copy numpy arrays (e.g. ``from_jax_params`` output) into the
    module's parameters, which must match them name for name and in
    shape and dtype."""
    params = dict(module.named_parameters())
    if set(params) != set(arrays):
        raise KeyError(
            f"parameter names differ: missing {sorted(set(params) - set(arrays))}, "
            f"unexpected {sorted(set(arrays) - set(params))}"
        )
    for name, p in params.items():
        t = _from_numpy(arrays[name])
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, want {tuple(p.shape)} {p.dtype}")
        p.copy_(t)
