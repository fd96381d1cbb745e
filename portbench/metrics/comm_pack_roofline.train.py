"""comm_pack_roofline.train: the byte bound of a step's packs and unpacks
(B1/B2: every gradient read as stored and every arena element written on
the wire, and the reverse) over their device time, in %."""

from portbench.counts import HBM_BYTES_PER_S, pack_bytes


def read(window, ctx):
    t, n = window.seconds_where(("pack_kernel",))  # unpack_kernel holds it too
    if n == 0 or t == 0:
        return None
    per_step = 2 * pack_bytes(ctx["param_bytes"], ctx["param_elems"], ctx["wire_itemsize"])
    return 100.0 * per_step * window.steps / HBM_BYTES_PER_S / t
