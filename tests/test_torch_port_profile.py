"""`cpc_tpu_torch.train.profile_step`: its kernel-name stages, and that it
asks for a GPU (the profile itself runs only on the card)."""

import pytest
import torch

from cpc_tpu_torch.train.profile_step import OTHER, main, stage_of


@pytest.mark.parametrize("name,stage", [
    ("void gru_scan_bwd_kernel<__nv_bfloat16>(...)",
     "GRU backward recurrence"),
    ("void gru_scan_fwd_kernel<float>(...)", "GRU forward"),
    ("void (anonymous namespace)::gru_fwd_resident_kernel<__nv_bfloat16, 8>"
     "(...)", "GRU forward"),
    ("void (anonymous namespace)::gru_gates_kernel<__nv_bfloat16>(...)",
     "GRU backward gates"),
    ("void (anonymous namespace)::gru_bwd_resident_kernel<float, 16>(...)",
     "GRU backward recurrence"),
    ("void gru_bwd_reduce_kernel<__nv_bfloat16>(...)", "GRU dwh/dbh"),
    ("gru_bwd_finish_kernel(float const*, ...)", "GRU dwh/dbh"),
    ("void heads_nll_fwd_kernel<float>(...)", "fused heads + InfoNCE forward"),
    ("(anonymous namespace)::heads_fwd_mma_kernel(__nv_bfloat16 const*, ...)",
     "fused heads + InfoNCE forward"),
    ("void (anonymous namespace)::heads_bwd_mma_kernel<true>(float const*, "
     "...)", "fused heads + InfoNCE backward"),
    ("void (anonymous namespace)::heads_bwd_mma_kernel<false>(...)",
     "fused heads + InfoNCE backward"),
    ("void heads_delta_kernel<float>(...)", "fused heads + InfoNCE backward"),
    ("void heads_dz_kernel<__nv_bfloat16>(...)",
     "fused heads + InfoNCE backward"),
    ("void heads_dp_kernel<__nv_bfloat16>(...)",
     "fused heads + InfoNCE backward"),
    ("void same_step_fwd_kernel<__nv_bfloat16>(...)",
     "same-step InfoNCE forward"),
    ("void same_step_delta_kernel<float>(...)", "same-step InfoNCE backward"),
    ("void same_step_dz_kernel<__nv_bfloat16>(...)",
     "same-step InfoNCE backward"),
    ("void same_step_dp_kernel<__nv_bfloat16>(...)",
     "same-step InfoNCE backward"),
    ("void allsteps_fwd_kernel<__nv_bfloat16>(...)",
     "all-steps InfoNCE forward"),
    ("void allsteps_dp_kernel<__nv_bfloat16>(...)",
     "all-steps InfoNCE backward dP"),
    ("void allsteps_dz_kernel<float>(...)", "all-steps InfoNCE backward dZ"),
    ("(anonymous namespace)::allsteps_fwd_wgmma_kernel(__nv_bfloat16 const*, "
     "...)", "all-steps InfoNCE forward"),
    ("(anonymous namespace)::allsteps_dp_wgmma_kernel(float const*, ...)",
     "all-steps InfoNCE backward dP"),
    ("(anonymous namespace)::allsteps_dz_wgmma_kernel(float const*, ...)",
     "all-steps InfoNCE backward dZ"),
    ("(anonymous namespace)::allsteps_dz_finish_kernel(float4 const*, ...)",
     "all-steps InfoNCE backward dZ"),
    ("void flash_fwd_mma_kernel<32>(...)", "flash attention forward"),
    ("void flash_fwd_kernel<float, false, 1>(...)", "flash attention forward"),
    ("void flash_dq_mma_kernel<32>(...)", "flash attention backward dQ"),
    ("void flash_dkv_kernel<__nv_bfloat16, false, 1>(...)",
     "flash attention backward dK/dV"),
    ("void (anonymous namespace)::pyramid_wgmma_kernel<true>(__nv_bfloat16 "
     "const*, ...)", "conv pyramid forward"),
    ("void (anonymous namespace)::pyramid_wgmma_kernel<false>(...)",
     "conv pyramid forward"),
    ("void (anonymous namespace)::pyramid_simt_kernel<float, true>(...)",
     "conv pyramid forward"),
    ("void at::native::vectorized_layer_norm_kernel<c10::BFloat16, float>",
     "transformer"),
    ("void at::native::GammaBetaBackwardCUDAKernel<float, float>",
     "transformer"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::GeluCUDAKernelImpl(...)>", "transformer"),
    ("void cunn_SoftMaxForward<8, c10::BFloat16, float, ...>", "transformer"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv encoder"),
    ("sm90_xmma_wgrad_implicit_gemm_indexed_bf16bf16", "conv encoder"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<...>",
     "conv encoder"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmuls"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "matmuls"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", OTHER),
])
def test_stage_of_kernel_names(name, stage):
    assert stage_of(name).startswith(stage)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU exit")
def test_main_needs_a_gpu():
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        main([])
