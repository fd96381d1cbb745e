"""Core: the planning math (cost, comm and timeline models, schedules),
the parameter-to-bucket mapping, the gradient sync engine and the
trainer.  The JAX package's ``repro.core`` names resolve here too, each
imported from its submodule on first use (PEP 562), so importing this
package imports nothing and the planning math loads without the trainer.
As there, ``TPU_V5E`` is ``cost_model``'s ``Hardware`` preset and
``TPU_V5E_ICI`` is ``comm_model``'s interconnect.  The HLO readers
(``CollectiveStats``, ``SegmentCost``, ``parse_collectives``,
``segment_cost``) have no counterpart: the dry run counts on fake DTensors
(``launch.segments``)."""

from __future__ import annotations

import importlib

_SOURCES = {
    "comm_model": ("ALGORITHMS", "AllReduceModel", "TpuInterconnect", "binary_tree", "fit_affine",
                   "paper_cluster_model", "recursive_doubling", "recursive_halving_doubling",
                   "ring", "tpu_psum_model"),
    "cost_model": ("Hardware", "LayerCost", "NVIDIA_K80", "TPU_V5E", "lm_layer_costs"),
    "timeline": ("TimelineResult", "evaluate", "gradient_avail_times"),
    "schedule": ("Schedule", "evaluate_schedule", "fixed_bucket_schedule",
                 "groups_from_merged_set", "mg_wfbp_schedule", "optimal_schedule",
                 "synceasgd_schedule", "wfbp_schedule", "dp_optimal_schedule"),
    "bucketing": ("ArenaSlot", "CommUnit", "GroupArena", "ParamLayout", "bucket_assignment",
                  "group_arenas", "layer_buckets_for_scan", "layout_for_stacked_lm",
                  "layout_from_params", "stacked_lm_layout", "tree_get", "tree_set"),
    "sync": ("SyncConfig", "count_expected_allreduces", "make_gradient_sync", "wire_entries"),
}
#: public name -> (submodule, its name there)
_WHERE = {name: (mod, name) for mod, names in _SOURCES.items() for name in names}
_WHERE["TPU_V5E_ICI"] = ("comm_model", "TPU_V5E")

__all__ = sorted(_WHERE)


def __getattr__(name: str):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod, attr = _WHERE[name]
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), attr)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_WHERE))
