"""Decoder-only LM over block patterns (counterpart of
``repro/models/transformer.py``): dense ``('attn',)`` stacks, the Griffin
hybrid of ``'rec'`` (RG-LRU) and ``'attn_local'`` sublayers, and RWKV6's
``('rwkv',)`` stack.

Parameters are held per layer, so that a gradient hook fires per layer::

    embed                       (vocab, d)  f32
    stages.<i>.<kind>_<j>.norm{1,2}.scale         (.bias too for layernorm)
    stages.<i>.attn_0.attn.{wq,wk,wv,wo}          ('attn' / 'attn_local')
    stages.<i>.rec_0.mix.{w_main,w_gate,conv_w,conv_b,wa,ba,wx,bx,lam,w_out}
    stages.<i>.<kind>_<j>.mlp.{w_gate,w_up,w_down}
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

Tied embeddings (gemma): the head is ``embed.T`` cast to ``param_dtype``
once per step, and the embedding output is scaled by ``sqrt(d)``.  At a
vocab of 64k or more and a sequence longer than (and a multiple of) 512
tokens the loss runs per 512-token chunk under activation checkpointing,
so the (B, S, vocab) f32 logits are never held whole.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..devices import resolve_device
from .common import ArchConfig
from .layers import MLP, MLPS, NORMS, AttentionBlock, LayerNorm, make_norm
from .rglru import RGLRUBlock, lam_init
from .rwkv6 import LORA_DECAY, LORA_MIX, RWKV6Block

KINDS = ("attn", "attn_local", "rec", "rwkv")
CHUNKED_CE_VOCAB = 64000  # big-vocab archs never materialize full logits
CE_SEQ_CHUNK = 512


def _check_supported(cfg: ArchConfig) -> None:
    kinds = set(cfg.pattern) | set(cfg.tail_pattern)
    rec_kind = None if cfg.recurrent is None else cfg.recurrent.kind
    unsupported = {
        "pattern": not kinds <= set(KINDS),
        "recurrent": ("rec" in kinds and rec_kind != "rglru")
                     or ("rwkv" in kinds and rec_kind != "rwkv6"),
        "norm": cfg.norm not in NORMS,
        # an 'rwkv' block carries its own channel mix; every other kind an MLP
        "mlp": cfg.mlp not in MLPS if kinds - {"rwkv"} else cfg.mlp != "rwkv_cmix",
        "attention": bool(kinds & {"attn", "attn_local"}) and cfg.attention is None,
        "remat": cfg.remat not in ("full", "none"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: options not ported yet: {bad}")


class SubLayer(nn.Module):
    """One sublayer: pre-norm attention (``'attn'``; ``'attn_local'`` over
    ``cfg.local_window`` keys) or pre-norm RG-LRU block (``'rec'``, held as
    ``mix``), then pre-norm MLP."""

    def __init__(self, cfg: ArchConfig, kind: str, device=None):
        super().__init__()
        self.norm1 = make_norm(cfg, device)
        self.norm2 = make_norm(cfg, device)
        if kind == "rec":
            self.mix = RGLRUBlock(cfg, device)
        else:
            window = cfg.local_window if kind == "attn_local" else None
            self.attn = AttentionBlock(cfg, cfg.attention, device, window=window)
        self.mlp = MLP(cfg, device)
        self.kind = kind

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + (self.mix(h) if self.kind == "rec" else self.attn(h, positions))
        return x + self.mlp(self.norm2(x))


def _sublayer(cfg: ArchConfig, kind: str, device) -> nn.Module:
    return RWKV6Block(cfg, device) if kind == "rwkv" else SubLayer(cfg, kind, device)


def _sublayers(cfg: ArchConfig, pattern: tuple[str, ...], device) -> nn.ModuleDict:
    return nn.ModuleDict({f"{kind}_{i}": _sublayer(cfg, kind, device) for i, kind in enumerate(pattern)})


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
            tn(sub.mlp.w_gate, d ** -0.5)
            tn(sub.mlp.w_up, d ** -0.5)
            tn(sub.mlp.w_down, cfg.d_ff ** -0.5)
            reset_norm(sub.norm1)
            reset_norm(sub.norm2)
        reset_norm(self.final_norm)
        if not cfg.tie_embeddings:
            tn(self.head, d ** -0.5)

    def sublayers(self) -> list[nn.Module]:
        """Every sublayer in forward order: the stages', then the tail's."""
        subs = [sub for stage in self.stages for sub in stage.values()]
        if self.cfg.tail_pattern:
            subs += list(self.tail.values())
        return subs

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states (B, S, d) of the token batch."""
        cfg = self.cfg
        x = nn.functional.embedding(tokens, self.embed).to(cfg.param_dtype)
        if cfg.tie_embeddings:  # gemma scaling
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.param_dtype, device=x.device)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        for sub in self.sublayers():
            if cfg.remat == "full" and torch.is_grad_enabled():
                x = checkpoint(sub, x, positions, use_reentrant=False)
            else:
                x = sub(x, positions)
        return self.final_norm(x)

    def loss(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy (the JAX package's ``loss_fn``)."""
        x = self.hidden(batch["tokens"])
        # tied: cast once per step, outside the checkpointed loss chunks
        head = self.embed.T.to(self.cfg.param_dtype) if self.cfg.tie_embeddings else self.head
        return ce_from_hidden(self.cfg, head, x, batch["targets"])


def _token_nll(head: torch.Tensor, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits = (x @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, targets[..., None].long())[..., 0]


def _chunk_nll(head: torch.Tensor, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.sum(_token_nll(head, x, targets))


def ce_from_hidden(cfg: ArchConfig, head: torch.Tensor, x: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy from the final-norm hidden states (the JAX
    package's ``_ce_from_hidden``, unmasked).  ``head`` is (d, vocab).

    Chunked path (vocab >= 64k, sequence a multiple of 512 and longer): the
    loss is summed per 512-token chunk, each under activation checkpointing,
    so only one chunk's (B, 512, vocab) f32 logits exist at a time, in the
    forward and again in backward."""
    B, seq = targets.shape
    if cfg.vocab >= CHUNKED_CE_VOCAB and seq > CE_SEQ_CHUNK and seq % CE_SEQ_CHUNK == 0:
        parts = [
            checkpoint(_chunk_nll, head, x[:, c : c + CE_SEQ_CHUNK],
                       targets[:, c : c + CE_SEQ_CHUNK], use_reentrant=False)
            for c in range(0, seq, CE_SEQ_CHUNK)
        ]
        return torch.sum(torch.stack(parts)) / (B * seq)
    return torch.mean(_token_nll(head, x, targets))


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
