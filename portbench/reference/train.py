"""The reference's training steps: the loss, every parameter's gradient
and AdamW, layer by layer so that the float32 activations of a whole
model never live at once (each layer's input is kept, the layer is run
again under autograd in the backward).

Parameters live in the dtype the configuration stores them in (``store``)
and are widened to float32 where they are read; AdamW's moments are
float32 and each update is computed in float32 and stored back in the
parameter's dtype, as the configuration states.
"""

from __future__ import annotations

import torch

from . import dense
from .common import Matmul, layernorm, token_nll


def head_names(cfg: dict) -> tuple[str, ...]:
    """The leaves read after the last layer; a tied head is the embedding table."""
    return ("final_norm.scale", "final_norm.bias",
            "embed" if cfg["tie_embeddings"] else "head")


def layer_prefix(cfg: dict, i: int) -> str:
    return f"stages.{i}.attn_0."


def _params(store: dict, names, grad: bool) -> dict[str, torch.Tensor]:
    return {n: store[n].float().requires_grad_(grad) for n in names}


def head_nll(P: dict, x: torch.Tensor, targets: torch.Tensor, cfg: dict, mm) -> torch.Tensor:
    """Per-token negative log-likelihoods from the last layer's output."""
    h = layernorm(x, P["final_norm.scale"], P["final_norm.bias"], cfg["norm_eps"])
    head = P["embed"].T if cfg["tie_embeddings"] else P["head"]
    return token_nll(mm(h, head), targets)


def loss_and_grads(store: dict, cfg: dict, tokens: torch.Tensor, targets: torch.Tensor,
                   mm: Matmul, keep_tokens: int | None = None):
    """``(loss, grads)``: the mean next-token loss over the batch (over its
    first ``keep_tokens`` positions when given) and float32 gradients by
    parameter name."""
    L, scale = cfg["n_layers"], cfg["embed_scale"]
    names = [[layer_prefix(cfg, i) + s for s in dense.LAYER] for i in range(L)]
    inputs = []
    with torch.no_grad():
        x = store["embed"].float()[tokens] * scale
        for i in range(L):
            inputs.append(x)
            P = {n.split("_0.", 1)[1]: t for n, t in _params(store, names[i], False).items()}
            x = dense.layer(P, x, cfg, mm)
    grads: dict[str, torch.Tensor] = {}
    x = x.requires_grad_()
    P = _params(store, head_names(cfg), True)
    nll = head_nll(P, x, targets, cfg, mm)
    loss = (nll if keep_tokens is None else nll[:, :keep_tokens]).mean()
    got = torch.autograd.grad(loss, [x, *P.values()])
    dx = got[0]
    grads.update(zip(P, got[1:]))
    del P, nll, got
    for i in reversed(range(L)):
        xi = inputs[i].requires_grad_()
        P = _params(store, names[i], True)
        y = dense.layer({n.split("_0.", 1)[1]: t for n, t in P.items()}, xi, cfg, mm)
        got = torch.autograd.grad(y, [xi, *P.values()], dx)
        dx = got[0]
        grads.update(zip(P, got[1:]))
        inputs[i] = None
        del P, y, got, xi
    g_embed = grads.pop("embed", None)  # the tied head's part
    if g_embed is None:
        g_embed = torch.zeros(store["embed"].shape, dtype=torch.float32, device=dx.device)
    g_embed.index_add_(0, tokens.reshape(-1), dx.reshape(-1, dx.shape[-1]), alpha=scale)
    grads["embed"] = g_embed
    return loss.detach(), grads


class AdamW:
    """AdamW with bias-corrected float32 moments and decoupled weight decay;
    ``step`` updates ``store`` in place."""

    def __init__(self, store: dict, opt: dict):
        self.opt, self.t = opt, 0
        self.m = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for n, p in store.items()}
        self.v = {n: torch.zeros_like(m) for n, m in self.m.items()}

    @torch.no_grad()
    def step(self, store: dict, grads: dict) -> None:
        o = self.opt
        self.t += 1
        bc1, bc2 = 1.0 - o["b1"] ** self.t, 1.0 - o["b2"] ** self.t
        for n, p in store.items():
            g = grads.pop(n)
            m, v = self.m[n], self.v[n]
            m.mul_(o["b1"]).add_(g, alpha=1.0 - o["b1"])
            v.mul_(o["b2"]).addcmul_(g, g, value=1.0 - o["b2"])
            upd = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"]) + o["weight_decay"] * p.float()
            p.copy_((p.float() - o["lr"] * upd).to(p.dtype))
            del g


def norms(tensors: dict) -> dict[str, float]:
    """The L2 norm of each tensor, summed in float64."""
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def readings(store: dict, cfg: dict, batches, steps: int, precision: str = "float32",
             keep_tokens: int | None = None) -> dict:
    """Train ``store`` (the seed's initial weights, in their stored dtypes)
    for ``steps`` steps on ``batches`` (``(tokens, targets)`` pairs) and
    read what the comparison needs: each step's loss, each leaf's step-1
    gradient norm, and each leaf's change over the steps.  ``store`` is
    consumed."""
    mm = Matmul(precision)
    first = {n: p.clone() for n, p in store.items()}
    opt = AdamW(store, cfg["optimizer"])
    losses, grad_norms = [], None
    for s in range(steps):
        tokens, targets = batches[s]
        loss, grads = loss_and_grads(store, cfg, tokens, targets, mm, keep_tokens)
        losses.append(float(loss))
        if s == 0:
            grad_norms = norms(grads)
        opt.step(store, grads)
    del opt
    change = {}
    for n in list(first):
        change[n] = float(torch.linalg.vector_norm(store[n].detach().double()
                                                   - first.pop(n).double()))
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
