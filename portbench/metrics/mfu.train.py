"""mfu.train: the training step's model operations (``counts.step_flops``)
over the traced step time at the bf16 peak of every chip used, in %.  The
trace records the device's activity alone, so the traced step is as long
as an untraced one."""

from portbench.counts import PEAK_FLOPS


def read(window, ctx):
    if not window.kernels:
        return None
    step_s = window.wall_s / window.steps
    return 100.0 * ctx["step_flops"] / (step_s * PEAK_FLOPS["bfloat16"] * ctx["chips"])
