"""The dry run's input shapes, LM family: seq_len x global_batch
(counterpart of ``repro/configs/shapes.py``, the same data).

``decode_*`` / ``long_*`` run the decode step (one new token against a
seq_len KV cache); the others run the train step or the prefill.

long_500k needs sub-quadratic attention: it runs for the SSM, hybrid and
windowed archs and is skipped for the pure full-attention archs listed
below.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: Pure full-attention archs: every layer would need the full 500k KV and
#: the architecture defines no sub-quadratic mechanism -> skip long_500k.
LONG_CONTEXT_SKIP = frozenset(
    {
        "musicgen-large",
        "tinyllama-1.1b",
        "starcoder2-7b",
        "starcoder2-3b",
        "dbrx-132b",
        "qwen2-vl-2b",
    }
)


def applicable_shapes(arch: str) -> list[str]:
    out = []
    for name in SHAPES:
        if name == "long_500k" and arch in LONG_CONTEXT_SKIP:
            continue
        out.append(name)
    return out
