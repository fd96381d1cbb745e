"""flash_roofline.train: the summed bound of the window's flash launches
(B3 forward, B4 dQ, B5 dK/dV; ``counts.flash_work`` at the cell's shape,
the larger of bytes and bf16 operations) over their device time, in %."""

from portbench.counts import bound_s, flash_work


def read(window, ctx):
    cfg, mix = ctx["config"], ctx["mix"]
    if cfg.get("family") != "dense":
        return None
    work = flash_work(mix["batch"], mix["seq"], cfg["n_heads"], cfg["n_kv_heads"],
                      cfg["head_dim"], 2)
    total_s, bound = 0.0, 0.0
    for name, a, b in window.kernels:
        if "flash_" not in name:
            continue
        total_s += (b - a) / 1e6
        kind = ("fwd" if "flash_fwd" in name else "dq" if "flash_dq" in name
                else "dkv" if "flash_dkv" in name and "sum" not in name else None)
        if kind is not None:
            bound += bound_s(*work[kind])
    if total_s == 0:
        return None
    return 100.0 * bound / total_s
