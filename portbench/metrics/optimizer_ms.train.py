"""optimizer_ms.train: device ms a step of the kernels launched inside the
program's ``optimizer.update`` span (``phases``)."""

from portbench import phases


def read(window, ctx):
    w = phases.window_for(window, ctx)
    if w is None:
        return None
    t, n = w.phase_seconds("optimizer.update")
    return 1e3 * t / w.steps if n else None
