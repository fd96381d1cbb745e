"""idle_share.train: the share of the traced window in which no kernel ran
on the device (one minus the union of the kernels' intervals), in %."""


def read(window, ctx):
    if not window.kernels:
        return None
    return 100.0 * (1.0 - window.busy_s / window.wall_s)
