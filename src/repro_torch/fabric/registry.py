"""Backend-preset registry: one name -> one ``Fabric``.

Mirrors ``planning.registry`` (the scheduler-policy registry): presets
register under a name, consumers select with a ``--fabric`` flag, and
``get_fabric`` also passes live ``Fabric`` instances straight through so
a freshly fitted ``MeasuredFabric`` slots into the same call sites as a
named analytic preset.
"""

from __future__ import annotations

from typing import Callable, TypeVar

from .model import Fabric

F = TypeVar("F", bound=Fabric)

_FABRICS: dict[str, Fabric] = {}


def register_fabric(
    name: str, fabric: Fabric | None = None, *, overwrite: bool = False
) -> Fabric | Callable[[F], F]:
    """Register ``fabric`` under ``name``.

    Usable directly (``register_fabric("measured", my_fabric)``) or as a
    decorator on a zero-arg factory/class whose instance becomes the
    preset.  Duplicate names raise unless ``overwrite=True`` (re-fitting
    a measured fabric overwrites deliberately).
    """
    if fabric is not None:
        if name in _FABRICS and not overwrite:
            raise ValueError(f"fabric {name!r} already registered")
        _FABRICS[name] = fabric
        return fabric

    def deco(obj: F) -> F:
        register_fabric(name, obj() if isinstance(obj, type) else obj, overwrite=overwrite)
        return obj

    return deco


def get_fabric(name: str | Fabric) -> Fabric:
    """Resolve a preset name (or pass a live instance through).

    Example::

        >>> get_fabric("gpu_nccl").cost("all_reduce", {"data": 8}).a > 0
        True
    """
    if not isinstance(name, str):
        if not hasattr(name, "cost"):
            raise TypeError(f"not a Fabric (no .cost): {type(name).__name__}")
        return name
    if name not in _FABRICS:
        known = ", ".join(sorted(_FABRICS))
        raise KeyError(f"unknown fabric {name!r}; known: {known}")
    return _FABRICS[name]


def available_fabrics() -> list[str]:
    """Registered preset names as a sorted list — directly usable as
    argparse ``choices`` and always in stable display order."""
    return sorted(_FABRICS)
