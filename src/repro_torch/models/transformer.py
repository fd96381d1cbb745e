"""Decoder-only LM, dense ``('attn',)`` path (counterpart of
``repro/models/transformer.py``).

Parameters are held per layer, so that a gradient hook fires per layer::

    embed                       (vocab, d)  f32
    stages.<i>.attn_0.attn.{wq,wk,wv,wo}
    stages.<i>.attn_0.mlp.{w_gate,w_up,w_down}
    stages.<i>.attn_0.norm{1,2}.scale
    final_norm.scale
    head                        (d, vocab)  param_dtype

The JAX package stacks ``stages`` on a leading ``n_stages`` axis
(``params['stages']['attn_0']['attn']['wq']`` is ``(n_stages, d, qd)``).
``param_shapes`` gives the port's parameters in that stacked shape tree,
which is what the planning layout is built over, and
``from_jax_params`` / ``to_jax_params`` convert numpy weights between the
two forms.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..devices import resolve_device
from .common import ArchConfig
from .layers import MLP, AttentionBlock, RMSNorm


def _check_supported(cfg: ArchConfig) -> None:
    unsupported = {
        "pattern": cfg.pattern != ("attn",),
        "tail_pattern": bool(cfg.tail_pattern),
        "tie_embeddings": cfg.tie_embeddings,
        "norm": cfg.norm != "rmsnorm",
        "mlp": cfg.mlp != "swiglu",
        "attention": cfg.attention is None,
        "remat": cfg.remat not in ("full", "none"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: options not ported yet: {bad}")


class SubLayer(nn.Module):
    """One ``'attn'`` sublayer: pre-norm attention, then pre-norm MLP."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, cfg.param_dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, cfg.param_dtype, device)
        self.attn = AttentionBlock(cfg, cfg.attention, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), positions)
        return x + self.mlp(self.norm2(x))


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
        self.stages = nn.ModuleList(
            nn.ModuleDict({f"{kind}_{i}": SubLayer(cfg, device) for i, kind in enumerate(cfg.pattern)})
            for _ in range(cfg.n_stages)
        )
        self.final_norm = RMSNorm(cfg.d_model, cfg.param_dtype, device)
        self.head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab, dtype=cfg.param_dtype, device=device))
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

        tn(self.embed, 1.0)
        d, qd = cfg.d_model, att.n_heads * att.head_dim
        for stage in self.stages:
            for sub in stage.values():
                for w in (sub.attn.wq, sub.attn.wk, sub.attn.wv):
                    tn(w, d ** -0.5)
                tn(sub.attn.wo, qd ** -0.5)
                tn(sub.mlp.w_gate, d ** -0.5)
                tn(sub.mlp.w_up, d ** -0.5)
                tn(sub.mlp.w_down, cfg.d_ff ** -0.5)
                sub.norm1.scale.fill_(1.0)
                sub.norm2.scale.fill_(1.0)
        self.final_norm.scale.fill_(1.0)
        tn(self.head, d ** -0.5)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states (B, S, d) of the token batch."""
        cfg = self.cfg
        x = nn.functional.embedding(tokens, self.embed).to(cfg.param_dtype)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        for stage in self.stages:
            for sub in stage.values():
                if cfg.remat == "full" and torch.is_grad_enabled():
                    x = checkpoint(sub, x, positions, use_reentrant=False)
                else:
                    x = sub(x, positions)
        return self.final_norm(x)

    def loss(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy (the JAX package's ``loss_fn``,
        standard path: full logits, no chunking below 64k vocab)."""
        x = self.hidden(batch["tokens"])
        logits = (x @ self.head).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, batch["targets"][..., None].long())[..., 0]
        return torch.mean(lse - ll)


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
