"""Sharding rules and the activation-sharding context, on DeviceMesh and
DTensor (counterpart of ``repro/parallel/``)."""
