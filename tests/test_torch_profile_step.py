"""The profile's kernel classes (``repro_torch.launch.profile_step``): each
hand-written kernel of the port lands in its own class, by the names the
profiler reports for it, and library kernels in theirs."""

import pytest

from repro_torch.launch.profile_step import kernel_class

NAMES = [
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 256, 32, 32>(...)",
     "flash_attention"),
    ("void (anonymous namespace)::flash_dq_kernel<float, 64, 64, 64>(...)", "flash_attention"),
    ("void (anonymous namespace)::flash_dkv_kernel<float, 64, 64, 64>(...)", "flash_attention"),
    ("void (anonymous namespace)::flash_fwd_sm90_kernel<256>(__nv_bfloat16 const*, ...)",
     "flash_attention"),
    ("void (anonymous namespace)::flash_dq_sm90_kernel<256>(__nv_bfloat16 const*, ...)",
     "flash_attention"),
    ("void (anonymous namespace)::flash_dkv_sm90_kernel<64>(__nv_bfloat16 const*, ...)",
     "flash_attention"),
    ("(anonymous namespace)::flash_dkv_sum_kernel(float4 const*, float4 const*, ...)",
     "flash_attention"),
    ("void (anonymous namespace)::rglru_bwd_kernel(...)", "rglru"),
    ("void (anonymous namespace)::wkv_bwd_grad_kernel<64, __nv_bfloat16>((anonymous "
     "namespace)::Args<__nv_bfloat16, __nv_bfloat16>)", "rwkv6_wkv"),
    ("void (anonymous namespace)::wkv_fwd_state_kernel<64, __nv_bfloat16>((anonymous "
     "namespace)::Args<__nv_bfloat16>)", "rwkv6_wkv"),
    ("void (anonymous namespace)::wkv_fwd_out_kernel<32, float>((anonymous "
     "namespace)::Args<float>)", "rwkv6_wkv"),
    ("void (anonymous namespace)::unpack_kernel<float>(...)", "comm_pack"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void (anonymous namespace)::wkv_bwd_state_kernel<64, __nv_bfloat16>((anonymous "
     "namespace)::Args<__nv_bfloat16, float>)", "rwkv6_wkv"),
    ("void (anonymous namespace)::wkv_bwd_dv_kernel<32, float>((anonymous "
     "namespace)::Args<float, float>)", "rwkv6_wkv"),
    ("(anonymous namespace)::wkv_bwd_du_kernel(float const*, float*, int, int, int)",
     "rwkv6_wkv"),
    ("void (anonymous namespace)::wkv_step_kernel<64, __nv_bfloat16>((anonymous "
     "namespace)::Args<__nv_bfloat16, __nv_bfloat16>)", "rwkv6_wkv"),
]


@pytest.mark.parametrize("name,cls", NAMES,
                         ids=[f"{c}-{i}" for i, (_, c) in enumerate(NAMES)])
def test_kernel_class(name, cls):
    assert kernel_class(name) == cls
