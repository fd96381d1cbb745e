"""optimizer_roofline.train: AdamW's byte bound (``optcounts.adamw_bytes``
over the configuration's parameters at 3.35 TB/s) over the device time of
the kernels launched inside ``optimizer.update``, in %."""

from portbench import optcounts, phases
from portbench.counts import HBM_BYTES_PER_S


def read(window, ctx):
    w = phases.window_for(window, ctx)
    if w is None:
        return None
    t, n = w.phase_seconds("optimizer.update")
    if n == 0 or t == 0:
        return None
    per_step = optcounts.adamw_bytes(*optcounts.param_totals(ctx["config"]))
    return 100.0 * per_step * w.steps / HBM_BYTES_PER_S / t
