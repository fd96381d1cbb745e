"""Initial weights drawn from the seed, on the device, a few large draws.

Each group stacks one kind of leaf over the layers and is drawn in one
call from a generator of its own (seeded from the run's seed and the
group's name), so any group can be drawn again alone and gives the same
numbers on the same device.  Names are the measured program's parameter
names; both the program and the reference are handed these tensors.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run (weights of a group, traffic)."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    leaves: tuple[str, ...]  # one per stacked row
    shape: tuple[int, ...]  # of one leaf
    dtype: torch.dtype
    mean: float
    std: float


def storage_dtype(cfg: dict, name: str) -> torch.dtype:
    """The dtype a parameter is stored in, as the configuration states it."""
    last = name.split(".")[-1]
    return torch.float32 if last in cfg["f32_params"] else DTYPES[cfg["param_dtype"]]


def layer_shapes(cfg: dict) -> dict[str, tuple[tuple[int, ...], float, float]]:
    """Per-layer leaves by suffix: (shape, mean, std)."""
    d, f = cfg["d_model"], cfg["d_ff"]
    norms = {}
    if cfg["family"] == "dense":
        qd, kvd = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
        for k in ("norm1", "norm2"):
            norms[f"{k}.scale"] = ((d,), 1.0, 0.05)
            norms[f"{k}.bias"] = ((d,), 0.0, 0.05)
        return {**norms,
                "attn.wq": ((d, qd), 0.0, d ** -0.5), "attn.wk": ((d, kvd), 0.0, d ** -0.5),
                "attn.wv": ((d, kvd), 0.0, d ** -0.5), "attn.wo": ((qd, d), 0.0, qd ** -0.5),
                "mlp.w_up": ((d, f), 0.0, d ** -0.5), "mlp.w_down": ((f, d), 0.0, f ** -0.5)}
    raise ValueError(f"no weights for family {cfg['family']!r}")


def layer_prefix(cfg: dict, i: int) -> str:
    return f"stages.{i}.attn_0."


def groups(cfg: dict) -> list[Group]:
    """Every parameter of the model, as groups of one draw each."""
    d, V, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    tied = cfg["tie_embeddings"]  # a tied table is the head too: drawn at the head's std
    out = [Group("embed", ("embed",), (V, d), storage_dtype(cfg, "embed"), 0.0,
                 d ** -0.5 if tied else 1.0),
           Group("final_norm.scale", ("final_norm.scale",), (d,), storage_dtype(cfg, "scale"),
                 1.0, 0.05),
           Group("final_norm.bias", ("final_norm.bias",), (d,), storage_dtype(cfg, "bias"),
                 0.0, 0.05)]
    if not tied:
        out.append(Group("head", ("head",), (d, V), storage_dtype(cfg, "head"), 0.0, d ** -0.5))
    for suffix, (shape, mean, std) in layer_shapes(cfg).items():
        leaves = tuple(layer_prefix(cfg, i) + suffix for i in range(L))
        out.append(Group(suffix, leaves, shape, storage_dtype(cfg, suffix), mean, std))
    return out


@torch.no_grad()
def draw(group: Group, seed: int, device) -> torch.Tensor:
    """The group's leaves stacked, (n_leaves, *shape), in their dtype."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, f"w:{group.name}"))
    x = torch.randn((len(group.leaves),) + group.shape, generator=gen, dtype=group.dtype,
                    device=device)
    x.mul_(group.std).add_(group.mean)
    return x


def initial(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every initial parameter by name (views into the stacked draws)."""
    out = {}
    for g in groups(cfg):
        x = draw(g, seed, device)
        out.update(zip(g.leaves, x.unbind(0)))
    return out


@torch.no_grad()
def fill(params: dict[str, torch.Tensor], cfg: dict, seed: int) -> None:
    """Copy the seed's weights into the program's parameters (which must
    be exactly the groups' leaves, in shape and dtype)."""
    want = {n: g for g in groups(cfg) for n in g.leaves}
    if sorted(want) != sorted(params):
        extra, missing = sorted(set(params) - set(want)), sorted(set(want) - set(params))
        raise ValueError(f"the program's parameters differ from the config's: extra {extra[:5]}, "
                         f"missing {missing[:5]}")
    for g in groups(cfg):
        x = draw(g, seed, next(iter(params.values())).device)
        for n, row in zip(g.leaves, x.unbind(0)):
            p = params[n]
            if tuple(p.shape) != g.shape or p.dtype != g.dtype:
                raise ValueError(f"{n}: the program holds {tuple(p.shape)} {p.dtype}, "
                                 f"the config {g.shape} {g.dtype}")
            p.copy_(row)
        del x
