"""The one generator of the benchmark's traffic.  A mix is a data file
(``traffic/<name>.json``) of parameters; ``kind`` says which shape it is.

* ``lm_batches``: ``distinct_batches`` training batches of ``batch`` rows
  of ``seq`` token ids, uniform over the vocabulary, each row with its
  next-token targets; each data-parallel rank draws its own rows.
"""

from __future__ import annotations

import json
import pathlib

from .weights import subseed

HERE = pathlib.Path(__file__).resolve().parent


def load(name: str, root: pathlib.Path = HERE) -> dict:
    with open(root / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def lm_batches(mix: dict, vocab: int, seed: int, device, rank: int = 0, world: int = 1):
    """``[(tokens, targets)]``, each (batch, seq) int64 on ``device``: this
    rank's rows of every global batch, drawn in one call on the device."""
    import torch

    if mix["kind"] != "lm_batches":
        raise ValueError(f"{mix['kind']!r} mixes are not training batches")
    n, B, S = mix["distinct_batches"], mix["batch"], mix["seq"]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "traffic"))
    ids = torch.randint(0, vocab, (n, world * B, S + 1), generator=gen, device=device)
    ids = ids[:, rank * B:(rank + 1) * B]
    return [(ids[i, :, :-1].contiguous(), ids[i, :, 1:].contiguous()) for i in range(n)]

