"""The port's CUDA kernels on the card, each against its plain version on
the same CUDA tensors: the GRU recurrence forward and backward, the fused
heads + InfoNCE forward and backward, and the same-step and all-steps
InfoNCE on materialized predictions, forward and backward, and the causal
flash attention forward, one-pass backward, dQ and dK/dV, and the conv
encoder's pyramid
forward; then the extraction slice and a training step of each loss path,
of the transformer gar and of the `encoder.use_pallas` route on the card
against the same on the CPU, and a data-parallel step on a one-rank NCCL
group on the card against the CPU.

Every test here is marked `cuda` and skips without a GPU. The file imports
no jax, so it also runs where jax is not installed, without the suite's
conftest (which imports jax):

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""

import socket

import numpy as np
import pytest
import torch

from cpc_tpu_torch import CPCModel, extract_features, presets
from cpc_tpu_torch.config import (ArConfig, EncoderConfig, LossConfig,
                                  ModelConfig, apply_overrides)
from cpc_tpu_torch.ops import attention_cuda
from cpc_tpu_torch.ops.attention_cuda import (
    attention_route, flash_attention_backward,
    flash_attention_backward_reference, flash_attention_dkv,
    flash_attention_dkv_reference, flash_attention_dq,
    flash_attention_dq_reference, flash_attention_forward,
    flash_attention_forward_reference, flash_causal_mha,
    flash_causal_mha_backward_reference, row_dot)
from cpc_tpu_torch.ops.conv_cuda import (conv_chain, conv_pyramid_forward,
                                         conv_pyramid_reference,
                                         fused_conv_encoder)
from cpc_tpu_torch.ops.gru_cuda import (gru_route, gru_scan,
                                        gru_scan_backward,
                                        gru_scan_backward_reference,
                                        gru_scan_reference)
from cpc_tpu_torch.ops.infonce_allsteps_cuda import (
    allsteps_nll_backward, allsteps_nll_backward_reference,
    allsteps_nll_forward, allsteps_nll_reference)
from cpc_tpu_torch.ops.infonce_cuda import (same_step_nll_backward,
                                            same_step_nll_backward_reference,
                                            same_step_nll_forward,
                                            same_step_nll_reference)
from cpc_tpu_torch.ops.infonce_fused import (heads_nll_backward,
                                             heads_nll_backward_reference,
                                             heads_nll_forward,
                                             heads_nll_reference)
from cpc_tpu_torch.parallel import multihost
from cpc_tpu_torch.train.train_step import init_state, make_step_fns

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    # fp32 references in full fp32: no TF32 in matmuls or cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _scan_inputs(T, B, H, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def dev(a, dt):
        return torch.from_numpy(a).to("cuda", dt).contiguous()
    return (dev(rng.standard_normal((T, B, 3 * H)) * 0.5, dtype),
            dev(rng.standard_normal((H, 3 * H)) / np.sqrt(H), dtype),
            dev(rng.standard_normal(3 * H) * 0.1, torch.float32),
            dev(rng.uniform(-0.9, 0.9, (B, H)), torch.float32))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,B,H", [(128, 64, 256), (7, 3, 40), (5, 1, 1024)])
def test_kernel_matches_plain(T, B, H, dtype, tol):
    args = _scan_inputs(T, B, H, dtype)
    before = gru_scan.launches
    out = gru_scan(*args)
    torch.cuda.synchronize()
    assert gru_scan.launches == before + 1
    ref = gru_scan_reference(*args)
    assert out.dtype == dtype and out.shape == (T, B, H)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _rel(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


# relative to max(1, max |plain|): fp32 by summation order; bf16 outputs by
# about one rounding (2**-8) where an fp32 sum lands near a rounding edge
REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(128, 64, 256), (7, 3, 40), (3, 1, 1024),
                                   (600, 5, 32)])
def test_backward_kernel_matches_plain(T, B, H, dtype):
    xp, wh, bh, h0 = _scan_inputs(T, B, H, dtype)
    g = torch.randn((T, B, H), device="cuda").to(dtype)
    hs = gru_scan_reference(xp, wh, bh, h0)
    before = gru_scan_backward.launches
    got = gru_scan_backward(xp, wh, bh, h0, hs, g)
    torch.cuda.synchronize()
    assert gru_scan_backward.launches == before + 1
    want = gru_scan_backward_reference(xp, wh, bh, h0, hs, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        tol = REL[torch.float32 if b.dtype == torch.float32 else dtype]
        assert _rel(a, b) <= tol


def test_gradient_through_the_kernels_matches_the_plain_function():
    leaves = [a.clone().requires_grad_()
              for a in _scan_inputs(9, 3, 16, torch.float32)]
    g = torch.randn((9, 3, 16), device="cuda")
    torch.autograd.backward(gru_scan(*leaves), g)
    want = gru_scan_backward_reference(
        *[a.detach() for a in leaves],
        gru_scan_reference(*[a.detach() for a in leaves]), g)
    for a, b in zip(leaves, want):
        torch.testing.assert_close(a.grad, b, rtol=0, atol=1e-5)


# (T, B, H): the resident route (H = 256 and 32) at one row, at ragged last
# tiles of a cluster's 16 rows and beyond one tile, at one step and at many;
# the streamed route at a width that is no whole warp, at widths whose slice
# of wh does not fit a block, and at many steps
ROUTE_SHAPES = [(1, 1, 256), (600, 3, 256), (5, 17, 256), (9, 65, 256),
                (4, 3, 32), (6, 17, 64), (1, 3, 40), (600, 1, 40),
                (3, 17, 512), (2, 3, 1024), (4, 65, 40)]


def _route_id(shape):
    T, B, H = shape
    return f"{gru_route(B, H, torch.float32)}-T{T}-B{B}-H{H}"


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES, ids=_route_id)
def test_both_routes_match_plain_and_repeat(shape, dtype, tol):
    """Forward and backward of either route against the plain versions, and
    a second run of each bit for bit."""
    T, B, H = shape
    xp, wh, bh, h0 = _scan_inputs(T, B, H, dtype, seed=T + B + H)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (T, B, H))).to("cuda", dtype)
    out, again = gru_scan(xp, wh, bh, h0), gru_scan(xp, wh, bh, h0)
    ref = gru_scan_reference(xp, wh, bh, h0)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (T, B, H)
    assert torch.equal(out, again)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    got = gru_scan_backward(xp, wh, bh, h0, ref, g)
    twice = gru_scan_backward(xp, wh, bh, h0, ref, g)
    want = gru_scan_backward_reference(xp, wh, bh, h0, ref, g)
    torch.cuda.synchronize()
    for a, a2, b in zip(got, twice, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, a2)
        assert _rel(a, b) <= REL[torch.float32 if b.dtype == torch.float32
                                 else dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(9, 3, 256), (5, 17, 64), (9, 3, 40)],
                         ids=_route_id)
def test_autograd_function_gradient_on_either_route(shape, dtype):
    T, B, H = shape
    leaves = [a.clone().requires_grad_()
              for a in _scan_inputs(T, B, H, dtype, seed=3)]
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (T, B, H))).to("cuda", dtype)
    hs = gru_scan(*leaves)
    torch.autograd.backward(hs, g)
    detached = [a.detach() for a in leaves]
    want = gru_scan_backward_reference(*detached, hs.detach(), g)
    for a, b in zip(leaves, want):
        assert a.grad.dtype == b.dtype
        assert _rel(a.grad, b) <= REL[torch.float32
                                      if b.dtype == torch.float32 else dtype]


def _heads_inputs(T, B, C, K, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.standard_normal((T, B, K * D)) / np.sqrt(D))
    z = torch.from_numpy(rng.standard_normal((T, C, D)))
    g = torch.from_numpy(rng.standard_normal((T, K * B)))
    return (p.to("cuda", dtype), z.to("cuda", dtype),
            g.to("cuda", torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,C,K,D,shift", [
    (128, 64, 64, 12, 512, 0), (20, 3, 6, 3, 40, 3), (9, 70, 200, 2, 33, 65),
    (5, 1, 1, 4, 8, 0),
    # rank 1 of dp_global_negatives on two cards: 32 rows, a pool of 64
    (128, 32, 64, 12, 512, 32)])
def test_heads_kernels_match_plain(T, B, C, K, D, shift, dtype):
    p, z, g = _heads_inputs(T, B, C, K, D, dtype)
    before = (heads_nll_forward.launches, heads_nll_backward.launches)
    nll, cor, lse = heads_nll_forward(p, z, shift, K)
    r_nll, r_cor, r_lse = heads_nll_reference(p, z, shift, K)
    torch.cuda.synchronize()
    assert (nll - r_nll).abs().max().item() <= 1e-4
    assert (lse - r_lse).abs().max().item() <= 1e-4
    assert (cor != r_cor).float().mean().item() <= 1e-4  # near-ties only
    dz, dp = heads_nll_backward(g, r_lse, p, z, shift, K)
    r_dz, r_dp = heads_nll_backward_reference(g, r_lse, p, z, shift, K)
    torch.cuda.synchronize()
    assert (heads_nll_forward.launches, heads_nll_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    assert dz.dtype == torch.float32 and dp.dtype == dtype
    assert dp.shape == (K, T, B, D) and dz.shape == (T, C, D)
    assert _rel(dz, r_dz) <= REL[torch.float32]
    assert _rel(dp, r_dp) <= REL[dtype]


def test_heads_kernels_reject_what_they_do_not_take():
    p, z, _ = _heads_inputs(6, 2, 3, 2, 8, torch.float32)
    with pytest.raises(TypeError):
        heads_nll_forward(p.half(), z.half(), 0, 2)
    with pytest.raises(ValueError):
        heads_nll_forward(p[:, :, :-1], z, 0, 2)
    with pytest.raises(ValueError):
        heads_nll_forward(p.transpose(0, 1).contiguous().transpose(0, 1), z,
                          0, 2)


def _preds_inputs(B, T, C, K, D, dtype, seed=0, window_view=True):
    """Seeded preds_v (B, Tp, K, D), as the window of a (B, T, K, D) array
    or contiguous, z_pool (C, T, D) and the two cotangents."""
    rng = np.random.default_rng(seed)
    preds = torch.from_numpy(rng.standard_normal((B, T, K, D)) / np.sqrt(D))
    z = torch.from_numpy(rng.standard_normal((C, T, D)))
    g_same = torch.from_numpy(rng.standard_normal((T - 1, K * B)))
    g_all = torch.from_numpy(rng.standard_normal(((T - K) * K * B,)))
    preds_v = preds.to("cuda", dtype)[:, :T - K]
    if not window_view:
        preds_v = preds_v.contiguous()
    return (preds_v, z.to("cuda", dtype), g_same.to("cuda", torch.float32),
            g_all.to("cuda", torch.float32))


LOSS_KERNELS = {
    "same_step": (same_step_nll_forward, same_step_nll_reference,
                  same_step_nll_backward, same_step_nll_backward_reference),
    "all_steps": (allsteps_nll_forward, allsteps_nll_reference,
                  allsteps_nll_backward, allsteps_nll_backward_reference)}
# (B, T, C, K, D, shift): tpu_fast; ragged with a shifted pool; more than
# one row, column and D tile with ragged edges, D beyond one backward block;
# rank 1 of dp_global_negatives on two cards (32 rows, a pool of 64)
LOSS_SHAPES = [(64, 128, 64, 12, 512, 0), (3, 20, 6, 3, 40, 3),
               (70, 9, 200, 2, 33, 65), (2, 6, 3, 2, 520, 1),
               (32, 128, 64, 12, 512, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,K,D,shift", LOSS_SHAPES)
@pytest.mark.parametrize("negatives", ["same_step", "all_steps"])
def test_loss_kernels_match_plain(negatives, B, T, C, K, D, shift, dtype):
    fwd, fwd_ref, bwd, bwd_ref = LOSS_KERNELS[negatives]
    preds_v, z, g_same, g_all = _preds_inputs(
        B, T, C, K, D, dtype, window_view=dtype == torch.float32)
    g = g_same if negatives == "same_step" else g_all
    before = (fwd.launches, bwd.launches)
    nll, cor, lse = fwd(preds_v, z, shift)
    r_nll, r_cor, r_lse = fwd_ref(preds_v, z, shift)
    torch.cuda.synchronize()
    assert nll.shape == r_nll.shape
    assert (nll - r_nll).abs().max().item() <= 1e-4
    assert (lse - r_lse).abs().max().item() <= 1e-4
    assert (cor != r_cor).float().mean().item() <= 1e-4  # near-ties only
    dp, dz = bwd(g, r_lse, preds_v, z, shift)
    r_dp, r_dz = bwd_ref(g, r_lse, preds_v, z, shift)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    assert dp.dtype == dz.dtype == dtype and dp.is_contiguous()
    assert dp.shape == preds_v.shape and dz.shape == z.shape
    assert _rel(dp, r_dp) <= REL[dtype]
    # the all-steps dz sums over all R rows (89 088 at tpu_fast), not over
    # at most K*B = 768: fp32 summation order shows at 1.6e-5 there
    deep = negatives == "all_steps" and dtype == torch.float32
    assert _rel(dz, r_dz) <= (1e-4 if deep else REL[dtype])
    if negatives == "same_step":
        assert dz[:, 0].abs().max().item() == 0.0
    # the same result every run: no atomics on the sums
    dp2, dz2 = bwd(g, r_lse, preds_v, z, shift)
    assert torch.equal(dp, dp2) and torch.equal(dz, dz2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("negatives", ["same_step", "all_steps"])
def test_loss_kernels_exact_ties_go_to_the_lowest_column(negatives, dtype):
    fwd, fwd_ref, _, _ = LOSS_KERNELS[negatives]
    preds_v, z, _, _ = _preds_inputs(4, 150, 4, 2, 16, dtype)
    z[1] = z[0]                # candidates 0 and 1 tie at every step
    z[:, 100:] = z[:, 30:80]   # and ties 70 columns apart, across tiles
    got, want = fwd(preds_v, z, 0), fwd_ref(preds_v, z, 0)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert 0.0 < want[1].mean().item() < 1.0


def test_loss_kernels_reject_what_they_do_not_take():
    preds_v, z, g_same, _ = _preds_inputs(2, 6, 3, 2, 8, torch.float32)
    for fwd in (same_step_nll_forward, allsteps_nll_forward):
        with pytest.raises(TypeError):
            fwd(preds_v.half(), z.half(), 0)
        with pytest.raises(ValueError, match="outside the pool"):
            fwd(preds_v, z, 2)
        with pytest.raises(ValueError, match="Tp = T - K"):
            fwd(preds_v[:, :-1], z, 0)
        with pytest.raises(ValueError, match="contiguous"):
            fwd(preds_v.transpose(2, 3).contiguous().transpose(2, 3), z, 0)
    with pytest.raises(ValueError, match="contiguous"):
        allsteps_nll_forward(preds_v, z.transpose(0, 1).contiguous()
                             .transpose(0, 1), 0)
    with pytest.raises(ValueError, match="g_nll"):
        same_step_nll_backward(g_same[:-1], g_same, preds_v, z, 0)


@pytest.mark.parametrize("loss", [
    ["model.loss.fuse_heads=true"], ["model.loss.fuse_heads=false"],
    ["model.loss.negatives=all_steps"]])
def test_train_step_on_card_matches_cpu(loss):
    cfg = apply_overrides(presets.baseline(), [
        "model.encoder.channels=16,16,16,16,16", "model.encoder.d_enc=16",
        "model.ar.d_ar=16", "model.ar.use_pallas=true",
        "model.loss.prediction_steps=3", "model.loss.use_pallas=true",
        "data.batch_size=4", "data.snippet_samples=2560", *loss])
    batch = torch.from_numpy(np.clip(np.random.default_rng(0).standard_normal(
        (4, 2560)) * 5000, -32768, 32767).astype(np.int16))
    metrics, models = [], []
    for device in ("cpu", "cuda"):
        model = init_state(cfg, device)
        steps = make_step_fns(cfg, model)
        metrics.append([steps.train_step(batch.to(device)) for _ in range(2)])
        models.append(model)
    for m_cpu, m_gpu in zip(*metrics):
        for k in ("loss", "grad_norm", "acc"):
            torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-4,
                                       atol=1e-5)
    for (k, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5, msg=k)


def test_one_rank_nccl_dp_step_on_card_matches_cpu():
    cfg = apply_overrides(presets.dp_global_negatives(), [
        "model.encoder.channels=16,16,16,16,16", "model.encoder.d_enc=16",
        "model.ar.d_ar=16", "model.loss.prediction_steps=3",
        "model.dtype=float32", "model.loss.pallas_bf16=false",
        "data.batch_size=4", "data.snippet_samples=2560"])
    batch = torch.from_numpy(np.clip(np.random.default_rng(0).standard_normal(
        (4, 2560)) * 5000, -32768, 32767).astype(np.int16))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mesh = multihost.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        metrics, models = [], []
        for device, m in (("cpu", None), (mesh.device, mesh)):
            model = init_state(cfg, device)
            steps = make_step_fns(cfg, model, m)
            before = heads_nll_forward.launches
            metrics.append([steps.train_step(batch.to(device))
                            for _ in range(2)])
            models.append(model)
        assert heads_nll_forward.launches == before + 2
    finally:
        multihost.shutdown()
    for m_cpu, m_gpu in zip(*metrics):
        for k in ("loss", "grad_norm", "acc"):
            torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-4,
                                       atol=1e-5)
    for (k, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5, msg=k)


def test_kernel_rejects_too_wide_h():
    with pytest.raises(ValueError, match="H <="):
        gru_scan(*_scan_inputs(2, 1, 1025, torch.float32))


def test_slice_on_card_matches_cpu():
    mc = ModelConfig(encoder=EncoderConfig(channels=(16,) * 5, d_enc=16),
                     ar=ArConfig(d_ar=16, num_layers=2),
                     loss=LossConfig(prediction_steps=3))
    model = CPCModel(mc, generator=torch.Generator().manual_seed(0)).eval()
    wave = (np.random.default_rng(1).standard_normal(4 * 2560) * 0.3
            ).astype(np.float32)
    z, c = extract_features(model, wave, window=2560, batch_windows=2)
    before = gru_scan.launches
    zc, cc = extract_features(model.cuda(), wave, window=2560,
                              batch_windows=2)
    assert gru_scan.launches == before + 2 * 2  # batches x layers
    np.testing.assert_allclose(zc, z, rtol=0, atol=1e-4)
    np.testing.assert_allclose(cc, c, rtol=0, atol=1e-4)


# (B, T, H, Dh): transformer_fast; ragged T on the mma kernels (Dh 16, 64);
# Dh without an mma kernel; two 64-wide chunks of Dh; a long sweep
ATTN_SHAPES = [(64, 128, 8, 32), (2, 200, 3, 16), (1, 300, 2, 64),
               (2, 70, 3, 24), (1, 130, 2, 128), (2, 1024, 4, 32), (1, 1, 1, 8)]
ATTN_MODES = {"bf16_flash16": (torch.bfloat16, "bfloat16"),
              "bf16_flash": (torch.bfloat16, "float32"),
              "fp32_flash": (torch.float32, "float32"),
              "fp32_flash16": (torch.float32, "bfloat16")}
ATTN_KERNELS = (flash_attention_forward, flash_attention_backward,
                flash_attention_dq, flash_attention_dkv)


def _attn_inputs(B, T, H, Dh, dtype, seed=0):
    """q, k, v and a cotangent, (B, T, H, Dh), distinct per head and row."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, T, H, Dh))
                             ).to("cuda", dtype) for _ in range(4)]


@pytest.mark.parametrize("mode", sorted(ATTN_MODES))
@pytest.mark.parametrize("B,T,H,Dh", ATTN_SHAPES)
def test_attention_kernels_match_plain(B, T, H, Dh, mode):
    dtype, p_dtype = ATTN_MODES[mode]
    q, k, v, do = _attn_inputs(B, T, H, Dh, dtype)
    scale = Dh ** -0.5
    before = [fn.launches for fn in ATTN_KERNELS]
    o, lse = flash_attention_forward(q, k, v, scale, p_dtype)
    r_o, r_lse = flash_attention_forward_reference(q, k, v, scale, p_dtype)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape and o.is_contiguous()
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    # a bf16 P is rounded relative to the running max in the kernel and to
    # the row's max in the plain version, and a bf16 output rounds once more
    tol = 1e-2 if dtype == torch.bfloat16 \
        or p_dtype == "bfloat16" else 1e-5
    assert (lse - r_lse).abs().max().item() <= 1e-4
    assert _rel(o, r_o) <= tol
    dres = row_dot(do, r_o)
    args = (q, k, v, do, r_lse, dres, scale, p_dtype)
    dq = flash_attention_dq(*args)
    dk, dv = flash_attention_dkv(*args)
    r_dq = flash_attention_dq_reference(*args)
    r_dk, r_dv = flash_attention_dkv_reference(*args)
    torch.cuda.synchronize()
    # the forward and the pair's two kernels once each, in every mode
    assert [fn.launches for fn in ATTN_KERNELS] == \
        [before[0] + 1, before[1], before[2] + 1, before[3] + 1]
    for a, b in ((dq, r_dq), (dk, r_dk), (dv, r_dv)):
        assert a.dtype == dtype and a.shape == q.shape and a.is_contiguous()
        assert bool(torch.isfinite(a.float()).all())
        assert _rel(a, b) <= tol
    # the same result every run: no sum crosses blocks
    assert torch.equal(dq, flash_attention_dq(*args))
    dk2, dv2 = flash_attention_dkv(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    # the whole backward on the route the shape takes: the one-pass kernel
    # once, or the pair's kernels once more each
    route = attention_route(B, T, H, Dh, dtype, p_dtype)
    before = [fn.launches for fn in ATTN_KERNELS]
    got = flash_attention_backward(*args)
    torch.cuda.synchronize()
    one_pass = route.backward != "pair"
    assert one_pass == (mode == "bf16_flash16" and Dh in (16, 32, 64))
    assert [fn.launches for fn in ATTN_KERNELS] == \
        [before[0], before[1] + one_pass, before[2] + (not one_pass),
         before[3] + (not one_pass)]
    for a, b in zip(got, (r_dq, r_dk, r_dv)):
        assert a.dtype == dtype and a.shape == q.shape and a.is_contiguous()
        assert _rel(a, b) <= tol
    assert all(torch.equal(a, b)
               for a, b in zip(got, flash_attention_backward(*args)))


# the one-pass backward's routes: whatever the chooser would take, the
# head-resident kernel (where the head's dQ fits a block), and 2 or 4 groups
BACKWARD_ROUTES = {"chosen": {}, "resident": {"_RESIDENT_MIN_HEADS": 1},
                   "split_2": {"_RESIDENT_MIN_HEADS": 1 << 30,
                               "_MAX_GROUPS": 2},
                   "split_4": {"_RESIDENT_MIN_HEADS": 1 << 30}}
ONE_PASS_SHAPES = [s for s in ATTN_SHAPES if s[3] in (16, 32, 64)] + [
    (3, 64, 2, 32), (3, 65, 2, 16), (2, 129, 3, 64), (1, 1024, 2, 64),
    (2, 1024, 2, 16), (1, 700, 3, 32)]


@pytest.mark.parametrize("route", sorted(BACKWARD_ROUTES))
@pytest.mark.parametrize("B,T,H,Dh", ONE_PASS_SHAPES)
def test_one_pass_backward_matches_plain(B, T, H, Dh, route, monkeypatch):
    for name, value in BACKWARD_ROUTES[route].items():
        monkeypatch.setattr(attention_cuda, name, value)
    took = attention_route(B, T, H, Dh, torch.bfloat16, "bfloat16")
    assert took.backward.startswith("one_pass")
    if route.startswith("split") and T > 128:
        assert took.backward == "one_pass_split" and took.groups >= 2
    q, k, v, do = _attn_inputs(B, T, H, Dh, torch.bfloat16, seed=3)
    scale = Dh ** -0.5
    r_o, r_lse = flash_attention_forward_reference(q, k, v, scale, "bfloat16")
    args = (q, k, v, do, r_lse, row_dot(do, r_o), scale, "bfloat16")
    before = [fn.launches for fn in ATTN_KERNELS]
    got = flash_attention_backward(*args)
    again = flash_attention_backward(*args)
    torch.cuda.synchronize()
    assert [fn.launches for fn in ATTN_KERNELS] == \
        [before[0], before[1] + 2, before[2], before[3]]
    for a, b in zip(got, flash_attention_backward_reference(*args)):
        assert a.dtype == torch.bfloat16 and a.is_contiguous()
        assert bool(torch.isfinite(a.float()).all())
        assert _rel(a, b) <= 1e-2
    # the groups' partial sums are added in a fixed order
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_one_pass_backward_reads_strided_heads():
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((3, 150, 3, 4, 32))
                           ).to("cuda", torch.bfloat16)
    q, k, v = qkv.unbind(2)  # slices of one fused projection
    do = torch.from_numpy(rng.standard_normal((3, 150, 2, 4, 32))
                          ).to("cuda", torch.bfloat16)[:, :, 1]
    assert not q.is_contiguous() and not do.is_contiguous()
    r_o, r_lse = flash_attention_forward_reference(q, k, v, 0.2, "bfloat16")
    args = (q, k, v, do, r_lse, row_dot(do, r_o), 0.2, "bfloat16")
    before = flash_attention_backward.launches
    got = flash_attention_backward(*args)
    assert flash_attention_backward.launches == before + 1
    for a, b in zip(got, flash_attention_backward_reference(*args)):
        assert a.is_contiguous() and _rel(a, b) <= 1e-2


def test_one_pass_backward_gives_way_to_the_pair_on_unaligned_rows():
    # a view that starts 8 bytes into a row: no 16-byte copies
    wide = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 2, 70, 3, 36))).to("cuda", torch.bfloat16)
    q, k, v, do = (t[..., 4:] for t in wide)
    assert q.data_ptr() % 16 == 8
    r_o, r_lse = flash_attention_forward_reference(q, k, v, 0.2, "bfloat16")
    args = (q, k, v, do, r_lse, row_dot(do, r_o), 0.2, "bfloat16")
    before = [fn.launches for fn in ATTN_KERNELS]
    got = flash_attention_backward(*args)
    assert [fn.launches for fn in ATTN_KERNELS] == \
        [before[0], before[1], before[2] + 1, before[3] + 1]
    for a, b in zip(got, flash_attention_backward_reference(*args)):
        assert _rel(a, b) <= 1e-2


# the forward's switch: head-resident (one block a head) up to T = 128,
# tiled beyond; both take the row's max before scaling and raise on a scale
# that is not positive, which the fp32-P forward takes
@pytest.mark.parametrize("scale", [None, -0.3])
@pytest.mark.parametrize("B,T,H,Dh", [
    (3, 127, 2, 32), (3, 128, 2, 32), (3, 129, 2, 32), (2, 64, 2, 16),
    (2, 65, 3, 64), (1, 1024, 2, 64), (2, 1000, 2, 16), (2, 1, 1, 32)])
def test_forward_routes_match_plain(B, T, H, Dh, scale):
    route = attention_route(B, T, H, Dh, torch.bfloat16, "bfloat16")
    assert route.forward == ("resident" if T <= 128 else "tiled")
    q, k, v, _ = _attn_inputs(B, T, H, Dh, torch.bfloat16, seed=4)
    p_dtype = "bfloat16"
    before = flash_attention_forward.launches
    if scale is not None:
        with pytest.raises(ValueError, match="scale must be positive"):
            flash_attention_forward(q, k, v, scale, p_dtype)
        assert flash_attention_forward.launches == before
        p_dtype = "float32"
    scale = Dh ** -0.5 if scale is None else scale
    o, lse = flash_attention_forward(q, k, v, scale, p_dtype)
    r_o, r_lse = flash_attention_forward_reference(q, k, v, scale, p_dtype)
    torch.cuda.synchronize()
    assert flash_attention_forward.launches == before + 1
    assert (lse - r_lse).abs().max().item() <= 1e-4
    assert _rel(o, r_o) <= 1e-2


# the launches the library makes: the forward's rows a block on both sides
# of its switch, and the one-pass backward's shared memory, which
# `attention_route` counts for itself to choose between its routes
@pytest.mark.parametrize("Dh", [16, 32, 64])
@pytest.mark.parametrize("T", [100, 128, 129, 1024])
def test_launch_shape_is_what_the_route_assumes(T, Dh):
    B, H = 3, 2
    rows = 128 if T <= 128 else 64
    blocks, threads, smem = attention_cuda.launch_shape("forward", B, T, H,
                                                        Dh)
    assert (blocks, threads) == (B * H * -(-T // rows), 2 * rows)
    assert smem == (rows + 3 * 2 * 64) * (Dh + 8) * 2
    for groups in (0, 2):
        if groups > -(-T // 128) or attention_cuda.one_pass_smem(
                T, Dh, resident=not groups) > attention_cuda._SMEM_LIMIT:
            continue
        assert attention_cuda.launch_shape("backward", B, T, H, Dh, groups) \
            == (B * H * max(groups, 1), 256,
                attention_cuda.one_pass_smem(T, Dh, resident=not groups))


@pytest.mark.parametrize("mode", ["bf16_flash16", "fp32_flash"])
def test_attention_kernels_read_strided_heads(mode):
    dtype, p_dtype = ATTN_MODES[mode]
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((3, 150, 3, 4, 32))
                           ).to("cuda", dtype)
    q, k, v = qkv.unbind(2)  # slices of one fused projection
    assert not q.is_contiguous()
    o, lse = flash_attention_forward(q, k, v, 0.2, p_dtype)
    r_o, r_lse = flash_attention_forward_reference(q, k, v, 0.2, p_dtype)
    assert (lse - r_lse).abs().max().item() <= 1e-4
    assert _rel(o, r_o) <= REL[dtype]


def test_attention_kernels_reject_what_they_do_not_take():
    q, k, v, do = _attn_inputs(2, 10, 3, 8, torch.float32)
    with pytest.raises(TypeError):
        flash_attention_forward(q.half(), k.half(), v.half(), 1.0)
    with pytest.raises(ValueError, match="last axis"):
        flash_attention_forward(
            q.transpose(2, 3).contiguous().transpose(2, 3), k, v, 1.0)
    with pytest.raises(ValueError, match="Dh <="):
        wide = torch.zeros((1, 4, 1, 129), device="cuda")
        flash_attention_forward(wide, wide, wide, 1.0)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_dq(q, k, v, do, torch.zeros((2, 3, 9), device="cuda"),
                           torch.zeros((2, 3, 10), device="cuda"), 1.0)


@pytest.mark.parametrize("mode", sorted(ATTN_MODES))
def test_gradient_through_the_attention_kernels_matches_plain(mode):
    dtype, p_dtype = ATTN_MODES[mode]
    q, k, v, do = _attn_inputs(2, 90, 3, 32, dtype, seed=2)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    o = flash_causal_mha(*leaves, p_dtype=p_dtype)
    o.backward(do)
    r_o, r_lse = flash_attention_forward_reference(q, k, v, 32 ** -0.5,
                                                   p_dtype)
    want = flash_causal_mha_backward_reference(q, k, v, r_o, r_lse, do,
                                               p_dtype=p_dtype)
    tol = 1e-5 if mode == "fp32_flash" else 1e-2
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad, w) <= tol


@pytest.mark.parametrize("impl", ["xla", "flash", "flash16"])
def test_transformer_train_step_on_card_matches_cpu(impl):
    cfg = apply_overrides(presets.transformer_gar(), [
        "model.encoder.channels=16,16,16,16,16", "model.encoder.d_enc=16",
        "model.ar.d_ar=32", "model.ar.num_heads=2",
        "model.loss.prediction_steps=3", "model.loss.use_pallas=true",
        "model.loss.fuse_heads=true", "data.batch_size=4",
        "data.snippet_samples=12800", f"model.ar.attn_impl={impl}"])
    batch = torch.from_numpy(np.clip(np.random.default_rng(0).standard_normal(
        (4, 12800)) * 5000, -32768, 32767).astype(np.int16))
    metrics, models = [], []
    before = [fn.launches for fn in ATTN_KERNELS]
    for device in ("cpu", "cuda"):
        model = init_state(cfg, device)
        steps = make_step_fns(cfg, model)
        metrics.append([steps.train_step(batch.to(device)) for _ in range(2)])
        models.append(model)
    # two steps of an fp32 model: its backward is the pair of kernels (the
    # one-pass kernel takes bf16 inputs)
    n = 0 if impl == "xla" else 2 * cfg.model.ar.num_layers
    per_kernel = (n, 0, n, n)
    assert [fn.launches for fn in ATTN_KERNELS] == \
        [a + b for a, b in zip(before, per_kernel)]
    # fp32 model; under flash16 the bf16 P is rounded relative to the
    # running max on the card and to the row's max on the CPU
    rtol, atol = (1e-4, 1e-5) if impl != "flash16" else (2e-3, 1e-4)
    for m_cpu, m_gpu in zip(*metrics):
        for k in ("loss", "grad_norm", "acc"):
            torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=rtol,
                                       atol=atol)
    for (k, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=atol, msg=k)


# ------------------------------------------------- the conv encoder's pyramid
FULL_SPEC = ((512,) * 5, (10, 8, 4, 4, 4), (5, 4, 2, 2, 2))
NARROW_SPEC = ((32, 32, 48), (10, 8, 4), (5, 4, 2))
PYRAMID_CASES = {
    "tpu_fast": (FULL_SPEC, 2, 20480),
    "long_snippet": (FULL_SPEC, 1, 163840),
    "ragged_narrow": (NARROW_SPEC, 3, 3205),   # no stride divides 3 205
    "odd_channels": (((20, 33, 7), (10, 8, 4), (5, 4, 2)), 2, 1999),
    "stride_not_dividing_kernel": (((16, 24, 8), (7, 5, 3), (3, 2, 2)), 2,
                                   500),
    "pointwise_layers": (((8, 16, 16), (3, 1, 1), (2, 1, 1)), 2, 301),
    "one_layer": (((24,), (10,), (5,)), 3, 777),
    "two_layers": (((64, 40), (10, 8), (5, 4)), 2, 2560),
    "shorter_than_a_kernel": (NARROW_SPEC, 2, 7),
}
# relative to max(1, max |plain|): fp32 by summation order; a bf16 layer
# output lands one rounding (2**-8) apart where its fp32 sum is near a
# rounding edge, and the layers after it carry that on
PYRAMID_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _pyramid_inputs(spec, B, S, dtype, seed=0):
    channels, kernels, strides = spec
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S))).to("cuda", dtype)
    weights, biases, c_in = [], [], 1
    for ch, k in zip(channels, kernels):
        weights.append(torch.from_numpy(
            rng.standard_normal((ch, c_in, k)) * np.sqrt(2.0 / (c_in * k))
        ).to("cuda", dtype))
        biases.append(torch.from_numpy(rng.standard_normal(ch) * 0.1
                                       ).to("cuda", dtype))
        c_in = ch
    return x, weights, biases, kernels, strides


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PYRAMID_CASES))
def test_conv_pyramid_kernel_matches_plain(case, dtype):
    spec, B, S = PYRAMID_CASES[case]
    args = _pyramid_inputs(spec, B, S, dtype)
    before = conv_pyramid_forward.launches
    z = conv_pyramid_forward(*args)
    torch.cuda.synchronize()
    assert conv_pyramid_forward.launches == before + 1
    want = conv_pyramid_reference(*args)
    assert z.dtype == dtype and z.shape == want.shape and z.is_contiguous()
    assert bool(torch.isfinite(z.float()).all())
    assert float(want.float().abs().max()) > 0  # not all ReLU'd away
    assert _rel(z, want) <= PYRAMID_TOL[dtype]
    # the snippet's edges, where SAME padding must feed zeros, not relu(bias)
    for rows in (slice(0, 2), slice(-2, None)):
        assert _rel(z[:, rows], want[:, rows]) <= PYRAMID_TOL[dtype]
    # against the library's convolution too, and the same result every run
    assert _rel(z, conv_chain(*args)) <= PYRAMID_TOL[dtype]
    assert torch.equal(z, conv_pyramid_forward(*args))


def test_conv_pyramid_route_by_shape():
    from cpc_tpu_torch.ops.conv_cuda import pyramid_route

    def route(channels, kernels, strides):
        return pyramid_route(kernels, strides, channels, 4, 20480,
                             torch.bfloat16).route
    # the shapes the C export was asked about, as pyramids: layers 1 + 2
    # fused, a later layer, the narrow spec, odd channels, a kernel of one,
    # a layer-1 kernel beyond one k16 step
    assert route((512, 512), (10, 8), (5, 4)) == "wgmma"
    assert route((512, 512, 512), (10, 8, 4), (5, 4, 2)) == "wgmma"
    assert route((32, 32, 48), (10, 8, 4), (5, 4, 2)) == "wgmma"
    assert route((20, 33), (10, 8), (5, 4)) == "simt"  # odd
    assert route((8, 8, 16), (10, 8, 1), (5, 4, 1)) == "wgmma"  # k = 1
    assert route((512, 512), (20, 8), (5, 4)) == "simt"


def test_conv_pyramid_rejects_what_it_does_not_take():
    x, weights, biases, kernels, strides = _pyramid_inputs(
        NARROW_SPEC, 4, 1600, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        conv_pyramid_forward(x.T.contiguous().T, weights, biases, kernels,
                             strides)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv_pyramid_forward(x.half(), weights, biases, kernels, strides)
    with pytest.raises(ValueError, match=r"weights\[1\]"):
        conv_pyramid_forward(x, [weights[0], weights[2], weights[2]], biases,
                             kernels, strides)
    with pytest.raises(ValueError, match="must be torch.float32 on"):
        conv_pyramid_forward(x, [w.cpu() for w in weights], biases, kernels,
                             strides)
    # the differentiable entry point copies a strided x instead
    z = fused_conv_encoder(x.T.contiguous().T, weights, biases, kernels,
                           strides)
    assert _rel(z, conv_pyramid_reference(x, weights, biases, kernels,
                                          strides)) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradient_through_the_conv_pyramid_is_the_chains(dtype):
    x, weights, biases, kernels, strides = _pyramid_inputs(
        NARROW_SPEC, 3, 3205, dtype, seed=4)
    g = torch.randn((3, 81, 48), device="cuda").to(dtype)
    grads = []
    for fn in (fused_conv_encoder, conv_chain):
        leaves = [t.clone().requires_grad_() for t in (x, *weights, *biases)]
        z = fn(leaves[0], leaves[1:4], leaves[4:], kernels, strides)
        z.backward(g)
        grads.append([t.grad for t in leaves])
    # the backward recomputes through the chain: the same calls on the same
    # values, so the gradients are equal, not merely close
    for a, b in zip(*grads):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_pyramid_train_step_on_card_matches_cpu(dtype):
    cfg = apply_overrides(presets.tpu_fast(), [
        "model.encoder.channels=16,16,16,16,16", "model.encoder.d_enc=16",
        "model.encoder.use_pallas=true", "model.ar.d_ar=16",
        "model.loss.prediction_steps=3", "data.batch_size=4",
        "data.snippet_samples=5120", f"model.dtype={dtype}"])
    batch = torch.from_numpy(np.clip(np.random.default_rng(0).standard_normal(
        (4, 5120)) * 5000, -32768, 32767).astype(np.int16))
    metrics = []
    before = conv_pyramid_forward.launches
    for device in ("cpu", "cuda"):
        steps = make_step_fns(cfg, init_state(cfg, device))
        metrics.append([steps.train_step(batch.to(device)) for _ in range(2)])
    assert conv_pyramid_forward.launches == before + 2
    # fp32: summation order; bf16: one rounding of a layer's output carried
    # through the GRU and the loss
    rtol, atol = (1e-4, 1e-5) if dtype == "float32" else (5e-2, 1e-2)
    for m_cpu, m_gpu in zip(*metrics):
        for k in ("loss", "grad_norm"):
            torch.testing.assert_close(m_gpu[k].cpu().float(),
                                       m_cpu[k].float(), rtol=rtol, atol=atol)
