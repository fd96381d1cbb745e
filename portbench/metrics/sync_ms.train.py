"""sync_ms.train: device ms a step of the gradient sync's kernels, the
arena's pack and unpack (B1/B2) and NCCL's, by kernel name."""

from portbench.devtrace import kernel_class


def read(window, ctx):
    t = sum((b - a) / 1e6 for name, a, b in window.kernels
            if kernel_class(name) in ("comm_pack", "nccl"))
    if t == 0:
        return None
    return 1e3 * t / window.steps
