"""MG-WFBP in PyTorch and CUDA: the port of the ``repro`` JAX package.

Module names follow the JAX package so each file's counterpart is easy to
find (``repro/core/sync.py`` -> ``repro_torch/core/sync.py``).  This
package imports ``torch``, numpy and the standard library only; it never
imports ``jax`` or any ``repro`` module.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit CPU request they raise
(``repro_torch.devices.resolve_device``).
"""

from .devices import resolve_device

__all__ = ["resolve_device"]
