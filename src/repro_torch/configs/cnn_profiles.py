"""Layer profiles of the paper's own CNNs, GoogleNet and ResNet-50
(counterpart of ``repro/configs/cnn_profiles.py``), for the simulator and
the quickstart.

Each profile is an ordered list (forward order, paper layer 1..L) of
``(name, params, fwd_flops_per_image)``; backward flops are 2x forward
(weight and input gradients), the paper's Eq. 18 regime.  BatchNorm,
scale and bias parameters are folded into their conv's message (Caffe
sends them beside it; they are under 1% of the payload).

The totals are the paper's: GoogleNet about 13M (bvlc googlenet's ~7.0M
and two auxiliary classifiers of ~3.2M each, which Caffe trains with and
so communicates), ResNet-50 about 25.5M.
"""

from __future__ import annotations

from ..core.cost_model import LayerCost


def _conv(name, cin, cout, k, hw, stride=1, params_extra=0):
    """(name, params, fwd_flops) of a conv with an hw x hw input."""
    params = cin * cout * k * k + cout + params_extra  # + bias (+ bn folded)
    out_hw = hw // stride
    flops = 2.0 * out_hw * out_hw * cin * cout * k * k
    return (name, params, flops)


def _fc(name, cin, cout):
    return (name, cin * cout + cout, 2.0 * cin * cout)


def googlenet_layers() -> list[tuple[str, int, float]]:
    """GoogleNet's layers with its two auxiliary classifiers."""
    L: list[tuple[str, int, float]] = []
    L.append(_conv("conv1/7x7_s2", 3, 64, 7, 224, stride=2, params_extra=128))
    L.append(_conv("conv2/3x3_reduce", 64, 64, 1, 56, params_extra=128))
    L.append(_conv("conv2/3x3", 64, 192, 3, 56, params_extra=384))
    # inception table: (in, 1x1, 3x3r, 3x3, 5x5r, 5x5, pool_proj, hw)
    incs = [
        ("3a", 192, 64, 96, 128, 16, 32, 32, 28),
        ("3b", 256, 128, 128, 192, 32, 96, 64, 28),
        ("4a", 480, 192, 96, 208, 16, 48, 64, 14),
        ("4b", 512, 160, 112, 224, 24, 64, 64, 14),
        ("4c", 512, 128, 128, 256, 24, 64, 64, 14),
        ("4d", 512, 112, 144, 288, 32, 64, 64, 14),
        ("4e", 528, 256, 160, 320, 32, 128, 128, 14),
        ("5a", 832, 256, 160, 320, 32, 128, 128, 7),
        ("5b", 832, 384, 192, 384, 48, 128, 128, 7),
    ]
    for nm, cin, c1, c3r, c3, c5r, c5, cp, hw in incs:
        L.append(_conv(f"inc{nm}/1x1", cin, c1, 1, hw, params_extra=2 * c1))
        L.append(_conv(f"inc{nm}/3x3_reduce", cin, c3r, 1, hw, params_extra=2 * c3r))
        L.append(_conv(f"inc{nm}/3x3", c3r, c3, 3, hw, params_extra=2 * c3))
        L.append(_conv(f"inc{nm}/5x5_reduce", cin, c5r, 1, hw, params_extra=2 * c5r))
        L.append(_conv(f"inc{nm}/5x5", c5r, c5, 5, hw, params_extra=2 * c5))
        L.append(_conv(f"inc{nm}/pool_proj", cin, cp, 1, hw, params_extra=2 * cp))
        # Caffe's bvlc_googlenet trains with two auxiliary classifiers,
        # after 4a and 4d: their gradients ride the wire too
        if nm in ("4a", "4d"):
            L.append(_conv(f"aux_{nm}/conv1x1", cin if nm == "4a" else 528, 128, 1, 4))
            L.append(_fc(f"aux_{nm}/fc1", 128 * 4 * 4, 1024))
            L.append(_fc(f"aux_{nm}/fc2", 1024, 1000))
    L.append(_fc("loss3/classifier", 1024, 1000))
    return L


def resnet50_layers() -> list[tuple[str, int, float]]:
    """ResNet-50's layers (bottleneck blocks, projection shortcuts)."""
    L: list[tuple[str, int, float]] = []
    L.append(_conv("conv1", 3, 64, 7, 224, stride=2, params_extra=128))
    # (stage, blocks, cin, cmid, cout, hw)
    stages = [
        ("res2", 3, 64, 64, 256, 56),
        ("res3", 4, 256, 128, 512, 28),
        ("res4", 6, 512, 256, 1024, 14),
        ("res5", 3, 1024, 512, 2048, 7),
    ]
    for nm, blocks, cin, cmid, cout, hw in stages:
        for b in range(blocks):
            c_in = cin if b == 0 else cout
            stride = 2 if (b == 0 and nm != "res2") else 1
            if b == 0:
                L.append(
                    _conv(f"{nm}a_branch1", c_in, cout, 1, hw * stride, stride=stride,
                          params_extra=2 * cout)
                )
            L.append(
                _conv(f"{nm}{'abcdef'[b]}_branch2a", c_in, cmid, 1, hw * stride,
                      stride=stride, params_extra=2 * cmid)
            )
            L.append(_conv(f"{nm}{'abcdef'[b]}_branch2b", cmid, cmid, 3, hw,
                           params_extra=2 * cmid))
            L.append(_conv(f"{nm}{'abcdef'[b]}_branch2c", cmid, cout, 1, hw,
                           params_extra=2 * cout))
    L.append(_fc("fc1000", 2048, 1000))
    return L


def cnn_layer_costs(
    which: str,
    batch_size: int,
    comm_dtype_bytes: int = 4,
) -> list[LayerCost]:
    """``LayerCost``s for the simulator (paper order: layer 1 first)."""
    layers = googlenet_layers() if which == "googlenet" else resnet50_layers()
    out = []
    for name, params, fwd_flops in layers:
        out.append(
            LayerCost(
                name=name,
                params=params,
                grad_bytes=params * comm_dtype_bytes,
                bwd_flops=2.0 * fwd_flops * batch_size,
                fwd_flops=fwd_flops * batch_size,
            )
        )
    return out


def total_params(which: str) -> int:
    """The profile's parameter count."""
    layers = googlenet_layers() if which == "googlenet" else resnet50_layers()
    return sum(p for _, p, _ in layers)
