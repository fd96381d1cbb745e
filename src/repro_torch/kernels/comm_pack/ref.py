"""Plain PyTorch versions of the gradient-arena pack/unpack pair
(counterparts of ``repro/kernels/comm_pack/ref.py``).

Pack writes each flattened gradient part into its slot of one flat wire
arena, casting to the wire dtype; with error feedback the carried
residual is added before the cast and the new residual is what the cast
dropped.  Unpack slices the reduced arena back into parts, fusing the
inverse cast and the DP averaging scale.

These are the arithmetic the CUDA kernels in ``csrc/comm_pack.cu`` must
reproduce bit for bit: every expression below is one rounding step
(``float`` add, cast, subtract, multiply), with nothing to contract into a
fused multiply-add.
"""

from __future__ import annotations

from typing import Sequence

import torch


def pack_arena_ref(
    parts: Sequence[torch.Tensor],  # gradient parts, any shape
    offsets: Sequence[int],  # element offset of each part in the arena
    size: int,  # total arena elements
    comm_dtype: torch.dtype,
    residuals: Sequence[torch.Tensor] | None = None,  # f32, same sizes
) -> tuple[torch.Tensor, list[torch.Tensor] | None]:
    """(arena, new_residuals); residuals None for the stateless cast.
    New residuals come back flat."""
    arena = torch.zeros(size, dtype=comm_dtype, device=parts[0].device)
    new_res: list[torch.Tensor] | None = None if residuals is None else []
    for i, (p, off) in enumerate(zip(parts, offsets)):
        p = p.reshape(-1)
        if residuals is not None:
            acc = p.float() + residuals[i].reshape(-1).float()
            wire = acc.to(comm_dtype)
            new_res.append(acc - wire.float())
        else:
            wire = p.to(comm_dtype)
        arena[off : off + wire.numel()] = wire
    return arena, new_res


def unpack_arena_ref(
    arena: torch.Tensor,  # 1-D reduced wire buffer
    slots: Sequence[tuple[int, int]],  # (offset, size) per part
    dtypes: Sequence[torch.dtype],  # destination dtype per part
    scale: float = 1.0,  # DP averaging factor (1/world)
) -> list[torch.Tensor]:
    """Flat parts sliced out of the reduced arena, decompress + scale fused."""
    return [
        (arena[off : off + n].float() * scale).to(dt) for (off, n), dt in zip(slots, dtypes)
    ]
