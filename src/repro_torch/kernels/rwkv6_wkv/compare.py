"""Time the WKV6 forward's step kernel against its chunked pair on the card.

    python -m repro_torch.kernels.rwkv6_wkv.compare [--step-max-t 0,64] [--json-out PATH]

Builds copies of ``csrc/rwkv6_wkv.cu`` with ``kStepMaxT`` moved to each
given value (into ``build/``, one ``nvcc`` each, all started together):
the forward picks the step kernel for T up to that value and the chunked
pair past it, so the builds with 0 and 64 run the two designs at the same
T.  Each build is held against ``wkv_ref`` at (2, T, 4, 64) for T 1, 2, 63
and 64 with s0, bf16 r/k/v (2e-4 + 2e-4 relative).  Then the forward's
device time (torch.profiler) at (B, T, 64, 64), bf16 r/k/v with s0, as a
decode step gives them, for B 1 and 4 and T 1 to 64, each build in turn
and then in reverse order (the mean of the two readings), and the
crossover: the longest T at which the step kernel is faster at B 1.
Prints the card's name and power limit first.  CUDA only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess

import torch

from .. import _build
from .ops import SOURCE
from .ref import wkv_ref

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
OVER_T = [1, 2, 4, 8, 12, 16, 24, 32, 48, 64]
H, K = 64, 64  # RWKV6-7B's heads and head size


def variant(step_max_t: int) -> pathlib.Path:
    """A copy of the source whose forward takes the step kernel up to
    ``step_max_t``."""
    text, n = re.subn(r"constexpr int kStepMaxT = \d+;", f"constexpr int kStepMaxT = {step_max_t};",
                      SOURCE.read_text())
    if n != 1:
        raise RuntimeError(f"{SOURCE.name} defines kStepMaxT {n} times")
    path = _build.BUILD_DIR / "rwkv6_wkv_variants" / f"rwkv6_wkv_step{step_max_t}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    if not path.exists() or path.read_text() != text:
        path.write_text(text)
    return path


def load(values: list[int]) -> dict[int, ctypes.CDLL]:
    sources = {v: variant(v) for v in values}
    built = _build.build_many(list(sources.values()))
    libs = {}
    for v, src in sources.items():
        lib = ctypes.CDLL(str(built[src][0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
        lib.wkv_fwd.restype = lib.wkv_step_max_t.restype = ctypes.c_int
        if lib.wkv_step_max_t() != v:
            raise RuntimeError(f"the build for kStepMaxT {v} reports {lib.wkv_step_max_t()}")
        libs[v] = lib
    return libs


def inputs(B, T, seed=0):
    """r, k, v (bf16), w in ~(0.63, 0.999), u, s0, as phase 1d draws them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    r, k, v = (n(B, T, H, K).to(torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + 5.2 * torch.rand(B, T, H, K, generator=gen, device="cuda")))
    return r, k, v, w, 0.5 * n(H, K), n(B, H, K, K)


def caller(lib, r, k, v, w, u, s0):
    """A closure launching ``lib``'s forward into fresh outputs (the chunked
    pair's scratch allocated once, outside it)."""
    B, T = r.shape[:2]
    out = torch.empty(B, T, H, K, device="cuda")
    s_final = torch.empty(B, H, K, K, device="cuda")
    scratch = torch.empty(B, H, -(-T // 64), K, K, device="cuda")

    def fwd():
        err = lib.wkv_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                          s0.data_ptr(), out.data_ptr(), s_final.data_ptr(), scratch.data_ptr(),
                          B, T, H, K, 1, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out, s_final

    return fwd


def device_us(fn, calls: int = 20, tries: int = 3) -> float:
    """Device time per call, from torch.profiler's device events (a trace
    that lost events is taken again, up to ``tries`` times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ev = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(ev) >= calls and len(ev) % calls == 0:
            return sum(e.time_range.end - e.time_range.start for e in ev) / calls
    raise RuntimeError(f"the profiler recorded {len(ev)} device events for {calls} calls")


def check(name, lib) -> float:
    worst = 0.0
    for T in (1, 2, 63, 64):
        args = inputs(2, T, seed=T)
        out, s_final = caller(lib, *args)()
        want = wkv_ref(*args)
        torch.cuda.synchronize()
        for got, ref in zip((out, s_final), want):
            d = (got - ref).abs()
            if not bool((d <= 2e-4 + 2e-4 * ref.abs()).all()):
                raise AssertionError(f"{name}: T {T} differs from wkv_ref by {float(d.max()):.3e}")
            worst = max(worst, float(d.max()))
    return worst


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step-max-t", default="0,64")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the comparison measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi unavailable", flush=True)
    values = [int(x) for x in args.step_max_t.split(",")]
    libs = load(values)
    for v, lib in libs.items():
        print(f"[compare] kStepMaxT {v}: within 2e-4 + 2e-4 |ref| of wkv_ref at T 1, 2, 63, 64 "
              f"(max |diff| {check(v, lib):.3e})", flush=True)
    out: dict = {}
    for B in (1, 4):
        for T in OVER_T:
            args_ = inputs(B, T, seed=100 + T)
            calls = {v: caller(libs[v], *args_) for v in values}
            us: dict = {v: [] for v in values}
            for v in values + values[::-1]:
                us[v].append(device_us(calls[v]))
            mean = {v: sum(x) / len(x) for v, x in us.items()}
            nbytes = B * T * H * K * (3 * 2 + 4 + 4) + 2 * 4 * B * H * K * K + 4 * H * K
            out[f"({B}, {T})"] = {str(v): mean[v] for v in values}
            print(f"[compare] fwd ({B}, {T}, {H}, {K}) bf16 with s0, device us: "
                  + ", ".join(f"kStepMaxT {v} {mean[v]:.2f} ({'step' if T <= v else 'chunked'})"
                              for v in values)
                  + f"; bound {nbytes / HBM_BYTES_PER_S * 1e6:.2f} us ({nbytes / 1e6:.2f} MB)",
                  flush=True)
    if 0 in values and len(values) > 1:
        top = max(values)
        wins = [T for T in OVER_T if T <= top and out[f"(1, {T})"][str(top)] < out[f"(1, {T})"]["0"]]
        cross = max((T for T in wins if all(t in wins for t in OVER_T if t <= T)), default=0)
        out["crossover_b1"] = cross
        print(f"[compare] the step kernel is faster at B 1 through T {cross} (of {OVER_T})",
              flush=True)
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
