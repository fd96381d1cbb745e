"""Deterministic synthetic LM batches (numpy copy of
``repro/data/pipeline.py``'s ``SyntheticLMStream.batch_at``: the same
seed, step and rank give the same batch in both packages).

Every batch is a pure function of ``(seed, step, rank)``; each
data-parallel rank draws only its own rows.  The distribution mixes
Zipfian unigrams with a repeated motif, so the loss falls.

With ``input_mode='embeds'`` (the stub frontends of MusicGen and Qwen2-VL)
a batch carries ``embeds = table[tokens]`` in place of the tokens, where
``table`` is a (vocab, d_model) f32 array of standard normals from
``default_rng(seed + 7)`` times 0.02.  The JAX stream draws the table
again for every batch; it depends on ``seed`` alone, so this stream draws it
once, at its first embeds batch, and keeps it: the same numbers, without
redrawing vocab x d_model normals a step (0.93 GB at Qwen2-VL's width).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram_repeat: int = 8  # period of the repeated motif (learnable signal)
    input_mode: str = "tokens"  # 'tokens' | 'embeds'
    d_model: int = 0  # the embeds' width (embeds mode)


class SyntheticLMStream:
    """Stateless-per-step synthetic LM batches."""

    def __init__(self, cfg: DataConfig, host_rank: int = 0, host_count: int = 1):
        if cfg.global_batch % host_count:
            raise ValueError(f"batch {cfg.global_batch} does not split over {host_count} ranks")
        self.cfg = cfg
        self.host_rank = host_rank
        self.host_count = host_count
        self.host_batch = cfg.global_batch // host_count
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()
        self._motif = rng.integers(0, cfg.vocab, size=cfg.ngram_repeat)
        self._table: np.ndarray | None = None  # the embeds table, drawn at first use

    def embed_table(self) -> np.ndarray:
        """The (vocab, d_model) f32 table that embeds batches gather from."""
        if self._table is None:
            cfg = self.cfg
            rng = np.random.default_rng(cfg.seed + 7)
            self._table = rng.standard_normal((cfg.vocab, cfg.d_model)).astype(np.float32) * 0.02
        return self._table

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """``{'tokens', 'targets'}`` int32 (host_batch, seq_len) for ``step``;
        in embeds mode ``{'embeds' (host_batch, seq_len, d_model) f32,
        'targets'}``."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 65_537 + self.host_rank)
        B, S = self.host_batch, cfg.seq_len
        base = rng.choice(cfg.vocab, size=(B, S + 1), p=self._probs)
        motif_rows = rng.random(B) < 0.5
        reps = int(np.ceil((S + 1) / cfg.ngram_repeat))
        base[motif_rows] = np.tile(self._motif, reps)[: S + 1]
        tokens = base[:, :-1].astype(np.int32)
        out = {"targets": base[:, 1:].astype(np.int32)}
        if cfg.input_mode == "embeds":
            out["embeds"] = self.embed_table()[tokens]
        else:
            out["tokens"] = tokens
        return out


def make_stream(cfg: DataConfig, host_rank: int = 0, host_count: int = 1) -> SyntheticLMStream:
    return SyntheticLMStream(cfg, host_rank, host_count)
