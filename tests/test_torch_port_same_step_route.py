"""The same-step InfoNCE kernels' two routes on materialized predictions
(`ops/infonce_cuda.py`): `same_step_route`'s choices; the plain halves
(`_SameStepNllPlain`, the CPU path) against
`cpc_tpu.ops.infonce_pallas.fused_infonce` in interpret mode at the shapes
the tensor-core tiling cares about (B = C = 16: one 16-row fragment a head;
K*B no multiple of the 128 rows of a block; C = 70 > 64 with a shift: two
column tiles, the second ragged; preds_v the window preds[:, :Tp] of a
longer array); and, marked `cuda` and skipped without a GPU, the
tensor-core route against the plain versions at those shapes and at a
small tpu_fast-like one, two runs bit-identical, ties, a gradient through
`fused_same_step_nll`, the SIMT route on fp32 and unaligned bf16, and the
launch counters.

Tolerances are those of `test_torch_port_infonce_ktiled.py`: fp32 1e-5
relative, 1e-7 absolute (summation order); with compute_dtype=bf16 the
inputs are rounded to bf16 on both sides and the gradients come out in
bf16: 1e-2 relative, 1e-4 absolute. On the card, those of `chip_smoke.py`
phase 8: nll and lse 1e-4 absolute, argmax mismatches 1e-4 of the rows,
gradients relative to max |plain| (1e-2 in bf16, 1e-5 in fp32), and the
share of entries whose bf16 rounding differs from plain's.

jax is imported inside the JAX comparisons only, so that the `cuda` tests
run where jax is not installed:

    python -m pytest tests/test_torch_port_same_step_route.py -q -m cuda \\
        --noconftest
"""

import numpy as np
import pytest
import torch

from cpc_tpu_torch.ops.infonce_cuda import (_SameStepNllCuda,
                                            _SameStepNllPlain, fused_infonce,
                                            same_step_nll_backward,
                                            same_step_nll_backward_reference,
                                            same_step_nll_forward,
                                            same_step_nll_reference,
                                            same_step_route)
from cpc_tpu_torch.train.profile_step import stage_of

TOL = {None: (1e-5, 1e-7), torch.bfloat16: (1e-2, 1e-4)}


@pytest.fixture(autouse=True)
def _one_thread():
    # the tier-1 run shares the cores among 6 workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the route
@pytest.mark.parametrize("B,C", [(16, 16), (64, 64), (96, 130), (3, 70)])
@pytest.mark.parametrize("D,dtype,aligned,want", [
    (512, torch.bfloat16, True, "mma"), (40, torch.bfloat16, True, "mma"),
    (33, torch.bfloat16, True, "simt"), (12, torch.bfloat16, True, "simt"),
    (512, torch.bfloat16, False, "simt"), (512, torch.float32, True, "simt"),
    (33, torch.float32, False, "simt")])
def test_route_by_dtype_alignment_and_width(B, C, D, dtype, aligned, want):
    assert same_step_route(20, B, C, 12, D, dtype, aligned) == want


@pytest.mark.parametrize("args,err", [
    ((20, 16, 16, 12, 512, torch.float16), TypeError),
    ((20, 16, 16, 12, 512, torch.int8), TypeError),
    ((20, 0, 16, 12, 512, torch.bfloat16), ValueError),
    ((20, 16, 0, 12, 512, torch.float32), ValueError),
    ((0, 16, 16, 12, 512, torch.bfloat16), ValueError),
    ((20, 16, 16, 12, 0, torch.bfloat16), ValueError)])
def test_route_raises_on_what_no_kernel_takes(args, err):
    with pytest.raises(err):
        same_step_route(*args)


@pytest.mark.parametrize("name,stage", [
    ("void (anonymous namespace)::same_step_fwd_mma_kernel(...)",
     "same-step InfoNCE forward kernel"),
    ("void (anonymous namespace)::same_step_bwd_mma_kernel<true>(...)",
     "same-step InfoNCE backward kernels"),
    ("void (anonymous namespace)::same_step_bwd_mma_kernel<false>(...)",
     "same-step InfoNCE backward kernels")])
def test_profile_names_the_mma_kernels(name, stage):
    assert stage_of(name) == stage


# ------------------------------------------------- plain halves against JAX
def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _jax(preds_v, z, cdt=None, shift=0):
    import jax
    import jax.numpy as jnp

    import cpc_tpu.ops.infonce_pallas as jp
    jcdt = None if cdt is None else jnp.bfloat16

    def f(p, zz):
        return jp.fused_infonce(p, zz, shift=shift, compute_dtype=jcdt,
                                interpret=True)
    with jax.default_matmul_precision("highest"):
        (loss, m), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(preds_v), jnp.asarray(z))
    return float(loss), np.asarray(m["acc"]), [np.asarray(x) for x in g]


def _port(preds, z, Tp, cdt=None, shift=0):
    """fused_infonce on preds[:, :Tp] (the window of preds, uncopied in
    fp32); the gradient of preds past the window must be zero."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in (preds, z)]
    loss, m = fused_infonce(leaves[0][:, :Tp], leaves[1], shift=shift,
                            compute_dtype=cdt)
    loss.backward()
    dpreds = leaves[0].grad.numpy()
    assert not dpreds[:, Tp:].any()
    return loss.item(), m["acc"].numpy(), [dpreds[:, :Tp],
                                           leaves[1].grad.numpy()]


# (B, T, K, D, C, shift, extra steps of preds past the window): one 16-row
# fragment a head; K*B = 60 and 165, no multiple of 128; C = 70 with a
# shift; the window of a longer preds
JAX_SHAPES = [(16, 9, 3, 8, 16, 0, 0), (20, 12, 3, 16, 20, 0, 0),
              (33, 9, 5, 8, 33, 0, 0), (35, 7, 3, 8, 70, 35, 0),
              (4, 10, 3, 8, 4, 0, 3)]


@pytest.mark.parametrize("cdt", [None, torch.bfloat16])
@pytest.mark.parametrize("shape", JAX_SHAPES, ids=str)
def test_plain_halves_match_jax(shape, cdt):
    B, T, K, D, C, shift, extra = shape
    Tp = T - K
    preds = _rand((B, Tp + extra, K, D), 60)
    z = _rand((C, T, D), 61)
    got = _port(preds, z, Tp, cdt, shift)
    want = _jax(preds[:, :Tp], z, cdt, shift)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    rtol, atol = TOL[cdt]
    for name, a, b in zip(("dpreds", "dz"), got[2], want[2]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
    assert not got[2][1][:, 0].any()  # step 0 is never a target


def test_plain_function_is_the_cpu_path():
    """fused_infonce on CPU tensors is `_SameStepNllPlain`: no launch."""
    preds_v = torch.from_numpy(_rand((16, 6, 3, 8), 62))
    z = torch.from_numpy(_rand((16, 9, 8), 63))
    before = (same_step_nll_forward.launches, same_step_nll_backward.launches)
    nll, cor = _SameStepNllPlain.apply(preds_v, z, 0)
    want = same_step_nll_reference(preds_v, z, 0)
    torch.testing.assert_close(nll, want[0], rtol=0, atol=0)
    torch.testing.assert_close(cor, want[1], rtol=0, atol=0)
    assert (same_step_nll_forward.launches,
            same_step_nll_backward.launches) == before


# ------------------------------------------------------- on the card (cuda)
# (B, T, C, K, D, shift): tpu_fast-like with fewer steps; B = C = 16 heads
# that share a row fragment; K*B = 165, no multiple of 128; C = 70 > 64 with
# a shift (two column tiles, the second ragged, dz through its fp32
# scratch); D not a multiple of 64; 3 row groups with C > 64
CARD_SHAPES = [(64, 40, 64, 12, 512, 0), (16, 64, 16, 12, 512, 0),
               (33, 20, 33, 5, 64, 0), (24, 16, 70, 4, 64, 5),
               (16, 12, 16, 3, 40, 0), (3, 20, 6, 3, 40, 3),
               (70, 9, 200, 5, 136, 65)]
REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# bf16-flip shares of dz and dpreds, held over at least FLIP_MIN entries,
# as chip_smoke.py phase 8 holds them
FLIP_TOL = {"dz": 1e-3, "dpreds": 3e-4}
FLIP_MIN = 65536


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _card_inputs(B, T, C, K, D, dtype=torch.bfloat16, seed=0, extra=2):
    """preds_v as the window [:, :T-K] of a longer preds, cast to `dtype`
    (a strided window in bf16, as the cast of a bf16 model's preds is),
    z_pool (C, T, D) and a cotangent (T-1, K*B)."""
    rng = np.random.default_rng(seed)
    preds = torch.from_numpy(rng.standard_normal((B, T - K + extra, K, D))
                             / np.sqrt(D)).to("cuda", dtype)
    z = torch.from_numpy(rng.standard_normal((C, T, D))).to("cuda", dtype)
    g = torch.from_numpy(rng.standard_normal((T - 1, K * B))).to(
        "cuda", torch.float32)
    return preds[:, :T - K], z, g


def _rel(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def _flips_ok(name, got, want) -> bool:
    flips = (got.bfloat16() != want.bfloat16()).float().mean().item()
    return got.numel() < FLIP_MIN or flips <= FLIP_TOL[name]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_mma_route_matches_plain_and_repeats(shape):
    _need_cuda()
    B, T, C, K, D, shift = shape
    preds_v, z, g = _card_inputs(B, T, C, K, D)
    assert same_step_route(T, B, C, K, D, torch.bfloat16) == "mma"
    before = (same_step_nll_forward.launches, same_step_nll_backward.launches)
    nll, cor, lse = same_step_nll_forward(preds_v, z, shift)
    again = same_step_nll_forward(preds_v, z, shift)
    r_nll, r_cor, r_lse = same_step_nll_reference(preds_v, z, shift)
    # a cotangent and an lse that are not zero outside the window: the
    # kernel must not read them there
    dpreds, dz = same_step_nll_backward(g, r_lse + 1.0, preds_v, z, shift)
    dpreds2, dz2 = same_step_nll_backward(g, r_lse + 1.0, preds_v, z, shift)
    r_dpreds, r_dz = same_step_nll_backward_reference(g, r_lse + 1.0,
                                                      preds_v, z, shift)
    torch.cuda.synchronize()
    assert (same_step_nll_forward.launches,
            same_step_nll_backward.launches) == (before[0] + 2, before[1] + 2)
    for a, b in zip((nll, cor, lse), again):
        assert torch.equal(a, b)
    assert (nll - r_nll).abs().max().item() <= 1e-4
    assert (lse - r_lse).abs().max().item() <= 1e-4
    assert (cor != r_cor).float().mean().item() <= 1e-4  # near-ties only
    assert torch.equal(dz, dz2) and torch.equal(dpreds, dpreds2)
    assert dz.dtype == dpreds.dtype == torch.bfloat16
    assert _rel(dz, r_dz) <= REL[torch.bfloat16]
    assert _rel(dpreds, r_dpreds) <= REL[torch.bfloat16]
    assert _flips_ok("dz", dz, r_dz) and _flips_ok("dpreds", dpreds, r_dpreds)
    assert not dz[:, 0].any()  # exact zeros: never a target
    # out of window: exact zeros, as the plain version's mask makes them
    mask = r_nll == 0
    assert not nll[mask].any() and not cor[mask].any() and \
        not lse[mask].any()


@pytest.mark.cuda
def test_mma_route_exact_ties_go_to_the_first_maximum():
    _need_cuda()
    preds_v, z, _ = _card_inputs(16, 12, 70, 3, 64)
    z[1] = z[0]  # columns 0 and 1 tie exactly in every row
    z[66] = z[3]  # and a tie across the two column tiles
    _, cor, _ = same_step_nll_forward(preds_v, z, 0)
    _, r_cor, _ = same_step_nll_reference(preds_v, z, 0)
    assert torch.equal(cor, r_cor)


@pytest.mark.cuda
@pytest.mark.parametrize("C,shift", [(16, 0), (70, 37)])
def test_gradient_through_the_mma_route_matches_plain(C, shift):
    """`_SameStepNllCuda` (the mma route) against `_SameStepNllPlain` on the
    same bf16 CUDA tensors: nll, correct and the gradients of preds_v and
    z_pool."""
    _need_cuda()
    B, T, K, D = 16, 30, 3, 64
    preds_v, z, g = _card_inputs(B, T, C, K, D, seed=1)
    out = {}
    for fn in (_SameStepNllCuda, _SameStepNllPlain):
        xs = [x.detach().clone().requires_grad_() for x in (preds_v, z)]
        before = same_step_nll_backward.launches
        nll, cor = fn.apply(*xs, shift)
        nll.backward(g)
        launched = same_step_nll_backward.launches - before
        assert launched == (1 if fn is _SameStepNllCuda else 0)
        out[fn] = [nll, cor] + [x.grad for x in xs]
    card, plain = out[_SameStepNllCuda], out[_SameStepNllPlain]
    assert (card[0] - plain[0]).abs().max().item() <= 1e-4
    assert (card[1] != plain[1]).float().mean().item() <= 1e-4
    for a, b in zip(card[2:], plain[2:]):
        assert a.dtype == b.dtype == torch.bfloat16
        assert _rel(a, b) <= REL[torch.bfloat16]


@pytest.mark.cuda
def test_simt_route_on_unaligned_bf16_and_fp32():
    """D = 12 (bf16 rows of 24 bytes), a bf16 pool whose time stride is no
    multiple of 8, and the fp32 wire take the SIMT kernels; neither route
    gives way to the other."""
    _need_cuda()
    B, T, C, K = 5, 10, 7, 2
    for D, dtype, odd_pool in ((12, torch.bfloat16, False),
                               (16, torch.bfloat16, True),
                               (16, torch.float32, False)):
        preds_v, z, g = _card_inputs(B, T, C, K, D, dtype)
        if odd_pool:  # z[:, :, :D] of (C, T, D + 4): time stride D + 4
            wide = torch.zeros((C, T, D + 4), dtype=dtype, device="cuda")
            wide[..., :D] = z
            z = wide[..., :D]
            assert same_step_route(T, B, C, K, D, dtype, aligned=False) \
                == "simt"
        else:
            assert same_step_route(T, B, C, K, D, dtype) == "simt"
        before = same_step_nll_backward.launches
        nll, _, lse = same_step_nll_forward(preds_v, z, 1)
        r_nll, _, r_lse = same_step_nll_reference(preds_v, z, 1)
        assert (nll - r_nll).abs().max().item() <= 1e-4
        dpreds, dz = same_step_nll_backward(g, r_lse, preds_v, z, 1)
        r_dpreds, r_dz = same_step_nll_backward_reference(g, r_lse, preds_v,
                                                          z, 1)
        assert same_step_nll_backward.launches == before + 1
        assert _rel(dz, r_dz) <= REL[dtype]
        assert _rel(dpreds, r_dpreds) <= REL[dtype]
