"""Time builds of the RG-LRU kernels' source side by side on the card.

    python -m repro_torch.kernels.rglru.compare [--other NAME=PATH ...] [--json-out PATH]

Builds ``csrc/rglru.cu`` (named ``this``) and each ``--other`` source, one
``nvcc`` each, all started together, into ``build/``.  An other source is
another revision of ``rglru.cu`` with the same C interface (for example
``git show <rev>:src/repro_torch/kernels/rglru/csrc/rglru.cu``), or a copy
with ``kStepMaxT`` moved to time the forward's two kernels at the same T.
Each build is held against the plain versions at a ragged shape (1e-5;
gradients 1e-5 x max(1, max|g|)), then, in two passes (the builds in
order, then reversed), timed by torch.profiler's device time: the forward
and the backward at the training shape (1, 4096, 4096), the forward at the
prefill shape (1, 2304, 4096), each beside its byte bound and with whether
its bits are this build's; then the forward with h0 at (B, T, 4096) over
T, B 1 and 4.  Last, a device copy of as many bytes as the forward and the
backward move at the training shape: what the memory reaches on a plain
stream.  Prints the card's name and power limit first.  CUDA only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess

import torch

from .. import _build
from .ops import SOURCE
from .ref import rglru_bwd_ref, rglru_ref

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SHAPES = {"train": (1, 4096, 4096), "prefill": (1, 2304, 4096)}
OVER_T = [1, 2, 4, 8, 12, 13, 16, 32, 64]


def load(sources: dict[str, pathlib.Path]) -> dict[str, ctypes.CDLL]:
    built = _build.build_many(list(sources.values()))
    libs = {}
    for name, src in sources.items():
        lib = ctypes.CDLL(str(built[src][0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_fwd.argtypes = [p] * 5 + [i, i, i, p]
        lib.rglru_bwd.argtypes = [p] * 8 + [i, i, i, p]
        libs[name] = lib
    return libs


def inputs(B, T, W, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    return torch.sigmoid(2.0 * n(B, T, W) + 2.0), 0.5 * n(B, T, W), n(B, W), n(B, T, W)


def caller(lib, a, g, h0, dh):
    """(forward, backward) closures launching ``lib``'s kernels into fresh
    outputs; the backward reads the forward's h."""
    B, T, W = a.shape
    h, hT = torch.empty_like(a), torch.empty_like(a[:, 0])
    da, dg = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def fwd():
        err = lib.rglru_fwd(a.data_ptr(), g.data_ptr(), ptr(h0), h.data_ptr(), hT.data_ptr(),
                            B, T, W, stream())
        assert err == 0, err
        return h, hT

    def bwd():
        err = lib.rglru_bwd(a.data_ptr(), h.data_ptr(), ptr(h0), dh.data_ptr(), None,
                            da.data_ptr(), dg.data_ptr(), ptr(dh0), B, T, W, stream())
        assert err == 0, err
        return da, dg, dh0

    return fwd, bwd


def device_us(fn, calls: int = 20, tries: int = 3) -> float:
    """Kernel time per call, from torch.profiler's device events (each call
    launches a kernel: a trace that recorded fewer events than calls is
    taken again, up to ``tries`` times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(ev) >= calls:
            return sum(e.time_range.end - e.time_range.start for e in ev) / calls
    raise RuntimeError(f"the profiler recorded fewer device events than calls in {tries} traces")


def check(name, lib):
    a, g, h0, dh = inputs(3, 300, 41, seed=5)
    fwd, bwd = caller(lib, a, g, h0, dh)
    h, hT = fwd()
    got = bwd()
    want_h, _ = rglru_ref(a, g, h0)
    want = rglru_bwd_ref(a, h, h0, dh)
    torch.cuda.synchronize()
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5, msg=f"{name}: h")
    assert torch.equal(hT, h[:, -1]), name
    for x, ref in zip(got, want):
        assert float((x - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max())), name


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the comparison measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi unavailable", flush=True)
    sources = {"this": SOURCE}
    sources.update((k, pathlib.Path(v).resolve()) for k, v in (o.split("=", 1) for o in args.other))
    libs = load(sources)
    for name, lib in libs.items():
        check(name, lib)
    names = list(libs)
    out: dict = {name: {} for name in names}
    for tag, shape in SHAPES.items():
        a, g, _, dh = inputs(*shape)
        bound_ms = {"fwd": 12 * a.numel() / HBM_BYTES_PER_S * 1e3,
                    "bwd": 20 * a.numel() / HBM_BYTES_PER_S * 1e3}
        bits = {}
        for name in names + names[::-1]:
            fwd, bwd = caller(libs[name], a, g, None, dh)
            got = [x.clone() for x in (*fwd(), *bwd()[:2])]
            bits.setdefault(name, got)
            same = all(map(torch.equal, got, bits["this"])) if "this" in bits else None
            for kind, fn in (("fwd", fwd), ("bwd", bwd)):
                if tag == "prefill" and kind == "bwd":
                    continue
                ms = device_us(fn) / 1e3
                out[name].setdefault(f"{tag} {kind} ms", []).append(ms)
                print(f"[compare] {name}: {kind} {shape} device {ms:.4f} ms, bound "
                      f"{bound_ms[kind]:.4f} ms ({bound_ms[kind] / ms * 100:.1f}%); bits of "
                      f"this build: {same}", flush=True)
        del a, g, dh
    for B in (1, 4):
        for T in OVER_T:
            a, g, h0, dh = inputs(B, T, 4096, seed=T)
            us = {name: device_us(caller(libs[name], a, g, h0, dh)[0], calls=50) for name in names}
            for name in names:
                out[name][f"fwd ({B}, {T}, 4096) h0 us"] = us[name]
            print(f"[compare] fwd ({B}, {T}, 4096) with h0, device us: "
                  + ", ".join(f"{name} {v:.2f}" for name, v in us.items()), flush=True)
    for kind, nbytes in (("fwd", 12 * 4096 * 4096), ("bwd", 20 * 4096 * 4096)):
        src, dst = torch.empty(nbytes // 8, device="cuda"), torch.empty(nbytes // 8, device="cuda")
        us = device_us(lambda: dst.copy_(src))
        out[f"copy {kind} us"] = us
        print(f"[compare] device copy of the {kind}'s {nbytes / 1e6:.1f} MB: {us:.2f} us, "
              f"{nbytes / us / 1e6:.3f} TB/s", flush=True)
        del src, dst
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
