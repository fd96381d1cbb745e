"""backward_ms.train: device ms a step of the kernels launched inside the
program's ``bwd_*`` spans and no span nested in them (the recompute under
``remat='full'`` included, a ``dag`` step's packs not; ``phases``)."""

from portbench import phases


def read(window, ctx):
    w = phases.window_for(window, ctx)
    if w is None:
        return None
    t, n = w.phase_seconds("backward")
    return 1e3 * t / w.steps if n else None
