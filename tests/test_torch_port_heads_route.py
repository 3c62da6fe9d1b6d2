"""The fused heads + InfoNCE kernels' two routes (`ops/infonce_fused.py`):
`heads_route`'s choices; the plain halves (`_HeadsNllPlain`, the CPU path)
against `cpc_tpu.ops.infonce_fused.fused_heads_infonce` in interpret mode at
the shapes the tensor-core tiling cares about (B = C = 16: one 16-row
fragment a head; C = 70 > 64 with a shift: two column tiles, the second
ragged); and, marked `cuda` and skipped without a GPU, the tensor-core route
against the plain versions at those shapes, two runs bit-identical, and the
launch counters.

Tolerances are those of `test_torch_port_infonce.py`: fp32 1e-5 relative,
1e-7 absolute (summation order); with compute_dtype=bf16 the inputs are
rounded to bf16 on both sides and the gradients come out in bf16: 1e-2
relative, 1e-4 absolute. On the card, those of `test_torch_port_cuda.py`,
relative to the largest entry of plain, and for the backward the share of
entries whose bf16 rounding differs from plain's, as `chip_smoke.py`
phase 5 holds them.

jax is imported inside the JAX comparisons only, so that the `cuda` tests
run where jax is not installed:

    python -m pytest tests/test_torch_port_heads_route.py -q -m cuda \\
        --noconftest
"""

import numpy as np
import pytest
import torch

from cpc_tpu_torch.ops.infonce_fused import (_HeadsNllCuda, _HeadsNllPlain,
                                             fused_heads_infonce,
                                             heads_nll_backward,
                                             heads_nll_backward_reference,
                                             heads_nll_forward,
                                             heads_nll_reference,
                                             heads_route)

K, A, D = 3, 5, 8
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
@pytest.mark.parametrize("D_,dtype,aligned,want", [
    (512, torch.bfloat16, True, "mma"), (40, torch.bfloat16, True, "mma"),
    (33, torch.bfloat16, True, "simt"), (12, torch.bfloat16, True, "simt"),
    (512, torch.bfloat16, False, "simt"), (512, torch.float32, True, "simt"),
    (33, torch.float32, False, "simt")])
def test_route_by_dtype_alignment_and_width(B, C, D_, dtype, aligned, want):
    assert heads_route(20, B, C, 12, D_, dtype, aligned) == want


@pytest.mark.parametrize("args,err", [
    ((20, 16, 16, 12, 512, torch.float16), TypeError),
    ((20, 16, 16, 12, 512, torch.int8), TypeError),
    ((20, 0, 16, 12, 512, torch.bfloat16), ValueError),
    ((20, 16, 0, 12, 512, torch.float32), ValueError),
    ((0, 16, 16, 12, 512, torch.bfloat16), ValueError),
    ((20, 16, 16, 12, 0, torch.bfloat16), ValueError)])
def test_route_raises_on_what_no_kernel_takes(args, err):
    with pytest.raises(err):
        heads_route(*args)


# ------------------------------------------------- plain halves against JAX
def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _jax_dtype(cdt):
    import jax.numpy as jnp
    return None if cdt is None else jnp.bfloat16


def _assert_close(got, want, cdt, name):
    rtol, atol = TOL[cdt]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("cdt", [None, torch.bfloat16])
def test_plain_halves_match_jax_at_b_c_16(cdt):
    """B = C = 16, K*B = 48 rows a step: one 16-row fragment a head."""
    import jax
    import jax.numpy as jnp
    from cpc_tpu.ops.infonce_fused import fused_heads_infonce as jax_fused
    B, T = 16, 9
    c, z = _rand((B, T, A), 40), _rand((B, T, D), 41)
    W = _rand((A, K * D), 42, 0.5)

    def f(c, z, W):
        return jax_fused(c, z, W, num_steps=K, compute_dtype=_jax_dtype(cdt),
                         interpret=True)
    with jax.default_matmul_precision("highest"):
        (j_loss, j_m), j_grads = jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (c, z, W)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (c, z, W)]
    loss, m = fused_heads_infonce(*leaves, num_steps=K, compute_dtype=cdt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(m["acc"].numpy(), np.asarray(j_m["acc"]),
                               atol=1e-6)
    for name, x, want in zip(("dc", "dz", "dW"), leaves, j_grads):
        _assert_close(x.grad.numpy(), want, cdt, name)


@pytest.mark.parametrize("cdt", [None, torch.bfloat16])
def test_plain_halves_match_jax_at_c_70_with_a_shift(cdt):
    """C = 70 > 64: two column tiles, the second of 6. The pool is z
    all-gathered over R = 2 replicas of B = 35 under shard_map on the
    virtual CPU mesh, replica r's labels shifted by 35 r; the port gets the
    pool and the shift as arguments. Loss, per-k accuracy, dc and dW of each
    replica's loss; dz of the JAX side is the all-gather's transpose (the
    sum over replicas of each loss's gradient of the pool), held against the
    same sum of the port's."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cpc_tpu.ops.infonce_fused import fused_heads_infonce as jax_fused
    from cpc_tpu.parallel.mesh import make_mesh
    R, B, T = 2, 35, 7
    c, z = _rand((R * B, T, A), 43), _rand((R * B, T, D), 44)
    W = _rand((A, K * D), 45, 0.5)

    def local(cc, zz, ww):
        def f(cc, zz, ww):
            return jax_fused(cc, zz, ww, num_steps=K, axis_name="data",
                             compute_dtype=_jax_dtype(cdt), interpret=True)
        (loss, m), (dc, dz, dw) = jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True)(cc, zz, ww)
        return loss[None], m["acc"][None], dc, dz, dw[None]
    mesh = make_mesh((R,), ("data",), devices=jax.devices()[:R])
    run = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P("data"), P("data"), P()),
        out_specs=(P("data"),) * 5, check_vma=False))
    with jax.default_matmul_precision("highest"):
        j_loss, j_acc, j_dc, j_dz, j_dw = (np.asarray(o) for o in run(
            *map(jnp.asarray, (c, z, W))))
    pool = torch.from_numpy(z).requires_grad_()
    for r in range(R):
        rows = slice(r * B, (r + 1) * B)
        cr = torch.from_numpy(c[rows]).requires_grad_()
        zr = torch.from_numpy(z[rows])
        wr = torch.from_numpy(W).requires_grad_()
        loss, m = fused_heads_infonce(cr, zr, wr, num_steps=K, pool=pool,
                                      shift=r * B, compute_dtype=cdt)
        loss.backward()
        np.testing.assert_allclose(loss.item(), j_loss[r], rtol=1e-5)
        np.testing.assert_allclose(m["acc"].numpy(), j_acc[r], atol=1e-6)
        _assert_close(cr.grad.numpy(), j_dc[rows], cdt, f"dc of replica {r}")
        _assert_close(wr.grad.numpy(), j_dw[r], cdt, f"dW of replica {r}")
    _assert_close(pool.grad.numpy(), j_dz, cdt, "dz summed over replicas")


def test_plain_function_is_the_cpu_path():
    """fused_heads_infonce on CPU tensors is `_HeadsNllPlain`: no launch."""
    B, T = 16, 9
    c_tm = torch.from_numpy(_rand((T, B, A), 46))
    z_tm = torch.from_numpy(_rand((T, 16, D), 47))
    W = torch.from_numpy(_rand((A, K * D), 48, 0.5))
    before = (heads_nll_forward.launches, heads_nll_backward.launches)
    nll, cor = _HeadsNllPlain.apply(c_tm, z_tm, W, 0, K)
    p = (c_tm.reshape(T * B, A) @ W).reshape(T, B, K * D)
    want = heads_nll_reference(p, z_tm, 0, K)
    torch.testing.assert_close(nll, want[0], rtol=0, atol=0)
    torch.testing.assert_close(cor, want[1], rtol=0, atol=0)
    assert (heads_nll_forward.launches, heads_nll_backward.launches) == before


# ------------------------------------------------------- on the card (cuda)
# (T, B, C, K, D, shift): tpu_fast; transformer_fast's long context, cut to
# 64 steps; ragged B and C > 64 with a shift; B = 16 heads that share a
# row fragment with no padding; D not a multiple of 64
CARD_SHAPES = [(128, 64, 64, 12, 512, 0), (64, 16, 16, 12, 512, 0),
               (16, 24, 70, 4, 64, 5), (12, 16, 16, 3, 40, 0),
               (20, 3, 6, 3, 40, 3), (9, 70, 200, 2, 136, 65)]
REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# bf16-flip shares of dz and dp, held over at least FLIP_MIN entries
FLIP_TOL = {"dz": 1e-3, "dp": 3e-4}
FLIP_MIN = 65536


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _card_inputs(T, B, C, K_, D_, seed=0):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.standard_normal((T, B, K_ * D_)) / np.sqrt(D_))
    z = torch.from_numpy(rng.standard_normal((T, C, D_)))
    g = torch.from_numpy(rng.standard_normal((T, K_ * B)) / (T * B))
    return (p.to("cuda", torch.bfloat16), z.to("cuda", torch.bfloat16),
            g.to("cuda", torch.float32))


def _rel(got, want) -> float:
    """max |got - want| / max |want|: the cotangents are drawn at
    1/(T*B), so the gradients lie far below 1."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def _flips_ok(name, got, want) -> bool:
    flips = (got.bfloat16() != want.bfloat16()).float().mean().item()
    return got.numel() < FLIP_MIN or flips <= FLIP_TOL[name]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_mma_route_matches_plain_and_repeats(shape):
    _need_cuda()
    T, B, C, K_, D_, shift = shape
    p, z, g = _card_inputs(T, B, C, K_, D_)
    assert heads_route(T, B, C, K_, D_, torch.bfloat16) == "mma"
    before = (heads_nll_forward.launches, heads_nll_backward.launches)
    nll, cor, lse = heads_nll_forward(p, z, shift, K_)
    again = heads_nll_forward(p, z, shift, K_)
    r_nll, r_cor, r_lse = heads_nll_reference(p, z, shift, K_)
    dz, dp = heads_nll_backward(g, r_lse, p, z, shift, K_)
    dz2, dp2 = heads_nll_backward(g, r_lse, p, z, shift, K_)
    r_dz, r_dp = heads_nll_backward_reference(g, r_lse, p, z, shift, K_)
    torch.cuda.synchronize()
    assert (heads_nll_forward.launches, heads_nll_backward.launches) == \
        (before[0] + 2, before[1] + 2)
    for a, b in zip((nll, cor, lse), again):
        assert torch.equal(a, b)
    assert (nll - r_nll).abs().max().item() <= 1e-4
    assert (lse - r_lse).abs().max().item() <= 1e-4
    assert (cor != r_cor).float().mean().item() <= 1e-4  # near-ties only
    assert torch.equal(dz, dz2) and torch.equal(dp, dp2)
    assert dz.dtype == torch.float32 and dp.dtype == torch.bfloat16
    assert _rel(dz, r_dz) <= REL[torch.float32]
    assert _rel(dp, r_dp) <= REL[torch.bfloat16]
    assert _flips_ok("dz", dz, r_dz) and _flips_ok("dp", dp, r_dp)
    # out of window: exact zeros, as the Pallas validity mask makes them
    assert not dp[:, 0].any() and not dp[0, T - K_ + 1:].any()


@pytest.mark.cuda
def test_mma_route_exact_ties_go_to_the_first_maximum():
    _need_cuda()
    p, z, _ = _card_inputs(12, 16, 70, 3, 64)
    z[:, 1] = z[:, 0]  # columns 0 and 1 tie exactly in every row
    z[:, 66] = z[:, 3]  # and a tie across the two column tiles
    _, cor, _ = heads_nll_forward(p, z, 0, 3)
    _, r_cor, _ = heads_nll_reference(p, z, 0, 3)
    assert torch.equal(cor, r_cor)


@pytest.mark.cuda
@pytest.mark.parametrize("C,shift", [(16, 0), (70, 37)])
def test_gradient_through_the_mma_route_matches_plain(C, shift):
    """`_HeadsNllCuda` (the mma route) against `_HeadsNllPlain` on the same
    bf16 CUDA tensors: nll, correct and the gradients of c, z and W."""
    _need_cuda()
    B, T = 16, 30
    leaves = [torch.from_numpy(a).to("cuda", torch.bfloat16)
              for a in (_rand((T, B, A), 49), _rand((T, C, D), 50),
                        _rand((A, K * D), 51, 0.5))]
    g = torch.from_numpy(_rand((T, K * B), 52)).cuda()
    out = {}
    for fn in (_HeadsNllCuda, _HeadsNllPlain):
        xs = [x.clone().requires_grad_() for x in leaves]
        before = heads_nll_backward.launches
        nll, cor = fn.apply(*xs, shift, K)
        nll.backward(g)
        launched = heads_nll_backward.launches - before
        assert launched == (1 if fn is _HeadsNllCuda else 0)
        out[fn] = [nll, cor] + [x.grad for x in xs]
    card, plain = out[_HeadsNllCuda], out[_HeadsNllPlain]
    assert (card[0] - plain[0]).abs().max().item() <= 1e-4
    assert (card[1] != plain[1]).float().mean().item() <= 1e-4
    for a, b in zip(card[2:], plain[2:]):
        assert a.dtype == b.dtype == torch.bfloat16
        assert _rel(a, b) <= REL[torch.bfloat16]


@pytest.mark.cuda
def test_simt_route_on_unaligned_bf16_and_fp32():
    """D = 12 (bf16 rows of 24 bytes) and the fp32 wire take the SIMT
    kernels; neither route gives way to the other."""
    _need_cuda()
    for D_, dtype in ((12, torch.bfloat16), (16, torch.float32)):
        p, z, g = _card_inputs(10, 5, 7, 2, D_)
        p, z = p.to(dtype), z.to(dtype)
        assert heads_route(10, 5, 7, 2, D_, dtype) == "simt"
        nll, _, lse = heads_nll_forward(p, z, 1, 2)
        r_nll, _, r_lse = heads_nll_reference(p, z, 1, 2)
        assert (nll - r_nll).abs().max().item() <= 1e-4
        dz, dp = heads_nll_backward(g, r_lse, p, z, 1, 2)
        r_dz, r_dp = heads_nll_backward_reference(g, r_lse, p, z, 1, 2)
        assert _rel(dz, r_dz) <= REL[torch.float32]
        assert _rel(dp, r_dp) <= REL[dtype]
