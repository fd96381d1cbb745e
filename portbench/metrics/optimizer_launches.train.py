"""optimizer_launches.train: kernels a step launched inside the program's
``optimizer.update`` span (``phases``)."""

from portbench import phases


def read(window, ctx):
    w = phases.window_for(window, ctx)
    if w is None:
        return None
    _, n = w.phase_seconds("optimizer.update")
    return n / w.steps if n else None
