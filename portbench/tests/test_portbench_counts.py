"""The work and byte counts of ``portbench.counts``, pinned at values
reckoned by hand from the shapes (CPU only).

    PYTHONPATH=src python -m pytest -q portbench/tests
"""

import json
import pathlib

import pytest

from portbench import counts

HERE = pathlib.Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    with open(HERE / "configs" / f"{name}.json") as fh:
        return json.load(fh)


def test_starcoder2_step_flops():
    # a layer's products: q 3072x3072, k and v 3072x256, o 3072x3072, up and down
    # 3072x12288: 95,944,704 weights; 30 layers and the 3072 x 49152 head: 3,029,336,064
    cfg = config("starcoder2_3b")
    assert counts.matmul_params(cfg) == 3_029_336_064
    attention = 3 * 30 * 2 * 4096 * 4096 * 24 * 128  # causal QK and PV, x3 with the backward
    assert attention == 9_277_129_359_360
    want = 6 * 3_029_336_064 * 4096 + attention
    assert counts.step_flops(cfg, 1, 4096) == want == 83_726_092_468_224
    assert abs(want - 8.37e13) / 8.37e13 < 1e-3


def test_rwkv6_step_flops():
    # a layer's products: r, k, v, g, o 5 x 4096^2 = 83,886,080; the mix lora
    # 4096x160 + 5x32x4096 = 1,310,720; the decay lora 2 x 4096 x 64 = 524,288;
    # the channel mix 2 x 4096 x 14336 + 4096^2 = 134,217,728: 219,938,816 a layer;
    # 8 layers and the 4096 x 65536 head: 2,027,945,984
    cfg = {"family": "rwkv6", "n_layers": 8, "d_model": 4096, "d_ff": 14336, "vocab": 65536,
           "head_dim": 64}  # RWKV6-7B (arXiv:2404.05892), 8 of its 32 layers
    assert counts.matmul_params(cfg) == 2_027_945_984
    states = 4096 * 64 * 64 * 64  # a state element a step, (1, 4096, 64 heads, 64)
    wkv = 8 * (5 + 14) * states
    want = 6 * 2_027_945_984 * 4096 + wkv
    assert counts.step_flops(cfg, 1, 4096) == want == 50_002_009_260_032
    # without the loras (1,835,008 a layer) the count reads 4.95e13
    no_lora = 6 * (2_027_945_984 - 8 * 1_835_008) * 4096
    assert abs(no_lora - 4.95e13) / 4.95e13 < 2e-3


def test_flash_at_sc3_matches_the_kernel_table():
    # B3-B5 @SC3 (1, 4096, 24/2, hd 128): 103.1 / 154.6 / 206.2 GFLOP, bound by operations
    # at 0.1042 / 0.1564 / 0.2085 ms
    work = counts.flash_work(1, 4096, 24, 2, 128, 2)
    pairs = 24 * 4096 * 4097 // 2
    assert work["fwd"][1] == 4 * 128 * pairs == 103_104_380_928
    for kind, ms in (("fwd", 0.1042), ("dq", 0.1564), ("dkv", 0.2085)):
        assert counts.bound_s(*work[kind]) * 1e3 == pytest.approx(ms, abs=1e-4)
        nbytes, flops = work[kind]
        assert flops / counts.PEAK_FLOPS["bfloat16"] > nbytes / counts.HBM_BYTES_PER_S


def test_wkv_at_b7_matches_the_kernel_table():
    # B7 (1, 4096, 64, 64): 235.9 MB, bound 0.0704 ms by bytes; B7-bwd 503.3 MB, 0.1503 ms
    work = counts.wkv_work(1, 4096, 64, 64)
    assert work["fwd"][0] == 14 * 16_777_216 + 4 * 64 * 64 + 4 * 64 ** 3 == 235_945_984
    assert work["bwd"][0] == 30 * 16_777_216 + 8 * 64 * 64 == 503_349_248
    assert counts.bound_s(*work["fwd"], peak="3xtf32") * 1e3 == pytest.approx(0.0704, abs=1e-4)
    assert counts.bound_s(*work["bwd"], peak="3xtf32") * 1e3 == pytest.approx(0.1503, abs=1e-4)


def test_pack_bytes_of_starcoder2():
    # 3,029,710,848 parameters: 30 layers' 95,944,704 product weights and 4 x 3072 norm
    # leaves, the final norm's 2 x 3072 and the tied f32 table (603,979,776 bytes); the
    # rest in bf16 (5,757,431,808 bytes), each written to (and read from) an f32 arena
    n = 30 * (95_944_704 + 4 * 3072) + 2 * 3072 + 49152 * 3072
    assert n == 3_029_710_848
    param_bytes = 49152 * 3072 * 4 + (n - 49152 * 3072) * 2
    assert param_bytes == 6_361_411_584
    assert counts.pack_bytes(param_bytes, n) == 18_480_254_976
    assert counts.bound_s(2 * 18_480_254_976, 0) * 1e3 == pytest.approx(11.033, abs=1e-3)


def test_decode_bytes():
    # StarCoder2-3B's layers in bf16 with its tied head (the f32 table) and a 32 x 2048
    # f32 ring: 6.36 + 4.03 GB
    weights = 6_361_411_584
    cache = 30 * 2 * 32 * 2048 * 2 * 128 * 4 + 30 * 2048 * 4
    assert counts.decode_bytes(weights, cache) == weights + cache
    assert cache == 4_026_777_600
