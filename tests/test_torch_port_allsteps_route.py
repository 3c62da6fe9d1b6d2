"""The all-steps InfoNCE kernels' two routes (`ops/infonce_allsteps_cuda.py`):
`allsteps_route`'s choices and its dZ row groups; a plain model of the
wgmma dZ pass's grouped sum (fp32 partials over contiguous groups of
64-row tiles, added in group order) against `allsteps_nll_backward_reference`;
and, marked `cuda` and skipped without a GPU, the wgmma route against the
plain versions at `chip_smoke.py` phase 8's bf16 shapes, two runs
bit-identical, exact ties, gradients through `allsteps_nll`, and the launch
counters.

Tolerances on the card are those of `test_torch_port_cuda.py`: nll and lse
1e-4 absolute (fp32 from exact products), argmax mismatches on at most 1e-4
of the rows (near-ties), bf16 gradients 1e-2 relative to the largest entry
of plain (one rounding of the output). The file imports no jax:

    python -m pytest tests/test_torch_port_allsteps_route.py -q -m cuda \\
        --noconftest
"""

import math

import numpy as np
import pytest
import torch

from cpc_tpu_torch.ops.infonce_allsteps_cuda import (
    BWD_VECTORS, _AllStepsNllPlain, allsteps_nll,
    allsteps_nll_backward, allsteps_nll_backward_reference,
    allsteps_nll_forward, allsteps_nll_reference, allsteps_route)

TPU_FAST = (89_088, 8_192, 512)   # R, N, D: (B, T, C, K) = (64, 128, 64, 12)
LONG = (194_304, 16_384, 512)     # (16, 1024, 16, 12): transformer_fast's T


@pytest.fixture(autouse=True)
def _one_thread():
    # the tier-1 run shares the cores among 6 workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the route
@pytest.mark.parametrize("R,N", [TPU_FAST[:2], LONG[:2], (153, 120)])
@pytest.mark.parametrize("D,dtype,aligned,want", [
    (512, torch.bfloat16, True, "wgmma"), (72, torch.bfloat16, True, "wgmma"),
    (40, torch.bfloat16, True, "wgmma"), (576, torch.bfloat16, True, "wgmma"),
    (512, torch.bfloat16, False, "simt"), (72, torch.bfloat16, False, "simt"),
    (40, torch.bfloat16, False, "simt"), (33, torch.bfloat16, True, "simt"),
    (584, torch.bfloat16, True, "simt"), (512, torch.float32, True, "simt"),
    (72, torch.float32, True, "simt"), (40, torch.float32, False, "simt")])
def test_route_by_dtype_alignment_and_width(R, N, D, dtype, aligned, want):
    plan = allsteps_route(R, N, D, dtype, aligned)
    assert plan.route == want
    if want == "simt":
        assert plan.groups == 1


@pytest.mark.parametrize("args,err", [
    ((100, 64, 512, torch.float16), TypeError),
    ((100, 64, 512, torch.int8), TypeError),
    ((0, 64, 512, torch.bfloat16), ValueError),
    ((100, 0, 512, torch.bfloat16), ValueError),
    ((100, 64, 0, torch.float32), ValueError)])
def test_route_raises_on_what_no_kernel_takes(args, err):
    with pytest.raises(err):
        allsteps_route(*args)


def _blocks(R, N, D, groups):
    """The wgmma dZ pass's blocks and the dP pass's."""
    parts = math.ceil(D / 512)
    return (math.ceil(N / BWD_VECTORS) * parts * groups,
            math.ceil(R / BWD_VECTORS) * parts)


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("shape,groups", [(TPU_FAST, 2), (LONG, 1)])
def test_groups_fill_the_card_at_both_full_width_shapes(shape, groups, sms):
    plan = allsteps_route(*shape, torch.bfloat16, sms=sms)
    dz_blocks, dp_blocks = _blocks(*shape, plan.groups)
    assert dz_blocks >= sms and dp_blocks >= sms
    if sms == 132:
        assert plan.groups == groups
    # one group fewer would leave SMs without a dZ block
    if plan.groups > 1:
        assert _blocks(*shape, plan.groups - 1)[0] < sms


@pytest.mark.parametrize("R,N,D", [(1, 8, 16), (64, 8, 16), (100, 64, 40),
                                   (660, 333, 72), (65, 64, 512)])
def test_groups_never_exceed_the_row_tiles(R, N, D):
    plan = allsteps_route(R, N, D, torch.bfloat16)
    assert 1 <= plan.groups <= math.ceil(R / BWD_VECTORS)


# ------------------------------------------- the grouped dZ sum, in plain
def _rows(B, T, C, K, D, seed):
    rng = np.random.default_rng(seed)
    preds = torch.from_numpy(rng.standard_normal((B, T, K, D)) / np.sqrt(D))
    z = torch.from_numpy(rng.standard_normal((C, T, D)))
    g = torch.from_numpy(rng.standard_normal((T - K) * K * B))
    return (preds.float()[:, :T - K], z.float().contiguous(), g.float())


def test_grouped_dz_sum_matches_the_plain_backward():
    """dz as the wgmma route forms it: G partials, each over a contiguous
    group of 64-row tiles (tiles [q*RT/G, (q+1)*RT/G) of RT), in fp32,
    added in group order, against one plain backward over all rows."""
    B, T, C, K, D, shift = 3, 40, 5, 3, 16, 1
    preds_v, z, g = _rows(B, T, C, K, D, seed=7)
    R, N = (T - K) * K * B, C * T
    groups = allsteps_route(R, N, D, torch.bfloat16).groups
    row_tiles = math.ceil(R / BWD_VECTORS)
    assert groups == row_tiles == 6  # several groups, one tile each
    lse = allsteps_nll_reference(preds_v, z, shift)[2]
    want = allsteps_nll_backward_reference(g, lse, preds_v, z, shift)[1]
    got = torch.zeros_like(want)
    for q in range(groups):
        lo = q * row_tiles // groups * BWD_VECTORS
        hi = min(R, (q + 1) * row_tiles // groups * BWD_VECTORS)
        g_q = torch.zeros_like(g)
        g_q[lo:hi] = g[lo:hi]  # delta is zero on the other groups' rows
        got += allsteps_nll_backward_reference(g_q, lse, preds_v, z,
                                               shift)[1]
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-6


# ------------------------------------------------------- on the card (cuda)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _card_inputs(B, T, C, K, D, seed=0):
    preds_v, z, g = _rows(B, T, C, K, D, seed)
    return (preds_v.to("cuda", torch.bfloat16),
            z.to("cuda", torch.bfloat16), g.cuda())


def _rel(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def _plan(preds_v, z):
    B, Tp, K, D = preds_v.shape
    return allsteps_route(Tp * K * B, z.shape[0] * z.shape[1], D,
                          preds_v.dtype, sms=torch.cuda.get_device_properties(
                              0).multi_processor_count)


# chip_smoke.py phase 8's bf16 all-steps shapes (B, T, C, K, D, shift)
CARD_SHAPES = [(64, 128, 64, 12, 512, 0), (3, 20, 6, 3, 40, 3),
               (16, 1024, 16, 12, 512, 0), (5, 37, 9, 4, 72, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,K,D,shift", CARD_SHAPES)
def test_wgmma_route_matches_plain_and_repeats(B, T, C, K, D, shift):
    _need_cuda()
    preds_v, z, g = _card_inputs(B, T, C, K, D)
    assert _plan(preds_v, z).route == "wgmma"
    nll, cor, lse = allsteps_nll_forward(preds_v, z, shift)
    r_nll, r_cor, r_lse = allsteps_nll_reference(preds_v, z, shift)
    torch.cuda.synchronize()
    assert (nll - r_nll).abs().max().item() <= 1e-4
    assert (lse - r_lse).abs().max().item() <= 1e-4
    assert (cor != r_cor).float().mean().item() <= 1e-4  # near-ties only
    dp, dz = allsteps_nll_backward(g, r_lse, preds_v, z, shift)
    r_dp, r_dz = allsteps_nll_backward_reference(g, r_lse, preds_v, z, shift)
    torch.cuda.synchronize()
    assert dp.dtype == dz.dtype == torch.bfloat16
    assert dp.shape == preds_v.shape and dz.shape == z.shape
    assert _rel(dp, r_dp) <= 1e-2 and _rel(dz, r_dz) <= 1e-2
    # the same bits every run: no atomics, dZ's groups added in order
    dp2, dz2 = allsteps_nll_backward(g, r_lse, preds_v, z, shift)
    assert torch.equal(dp, dp2) and torch.equal(dz, dz2)


@pytest.mark.cuda
def test_wgmma_route_exact_ties_go_to_the_lowest_column():
    _need_cuda()
    preds_v, z, _ = _card_inputs(4, 150, 4, 2, 16)
    z[1] = z[0]                # candidates 0 and 1 tie at every step
    z[:, 100:] = z[:, 30:80]   # and ties 70 columns apart, across tiles
    assert _plan(preds_v, z).route == "wgmma"
    got = allsteps_nll_forward(preds_v, z, 0)
    want = allsteps_nll_reference(preds_v, z, 0)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert 0.0 < want[1].mean().item() < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,K,D,shift", [(3, 20, 6, 3, 40, 3),
                                             (5, 37, 9, 4, 72, 2)])
def test_gradient_through_allsteps_nll_matches_plain(B, T, C, K, D, shift):
    _need_cuda()
    preds_v, z, g = _card_inputs(B, T, C, K, D, seed=3)
    grads = []
    for run in (allsteps_nll, lambda p, zz, s: _AllStepsNllPlain.apply(
            p, zz, s)):
        leaves = [preds_v.clone().requires_grad_(),
                  z.clone().requires_grad_()]
        nll, _ = run(*leaves, shift)
        grads.append(torch.autograd.grad(nll, leaves, g))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype == torch.bfloat16
        assert _rel(got, want) <= 1e-2


@pytest.mark.cuda
def test_launch_counters_count_one_a_call():
    _need_cuda()
    preds_v, z, g = _card_inputs(3, 20, 6, 3, 40)
    before = (allsteps_nll_forward.launches, allsteps_nll_backward.launches)
    lse = allsteps_nll_forward(preds_v, z, 3)[2]
    allsteps_nll_backward(g, lse, preds_v, z, 3)  # three kernels, one call
    allsteps_nll_backward(g, lse, preds_v, z, 3)
    torch.cuda.synchronize()
    assert (allsteps_nll_forward.launches,
            allsteps_nll_backward.launches) == (before[0] + 1, before[1] + 2)
