"""The port's all-steps InfoNCE (`ops/infonce_allsteps_cuda.py`, on the CPU
its plain versions) against `cpc_tpu.ops.infonce_allsteps_pallas` with its
Pallas kernels in interpret mode at `jax.default_matmul_precision('highest')`:
loss, per-k accuracy, and the gradients of preds_v and of the pool.

Tolerances. fp32: 1e-5 relative on the loss, 1e-4 relative and 1e-7
absolute on gradients (the bound of the JAX package's own gradient test for
this kernel: the sums run over all C*T columns and all rows, in another
order). bf16 wire: both sides round preds_v and the pool to bf16, score and
take exp(s - lse) in fp32, round delta to bf16 before the two gradient
products, sum in fp32 and round the results to bf16. A delta that sits on a
rounding edge may round the other way (its fp32 value differs in the last
bit), and so may an output: 1e-2 relative (2**-8 is one bf16 rounding), 1e-4
absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpc_tpu.ops.infonce_allsteps_pallas as jp
from cpc_tpu.ops.infonce_pallas import fused_infonce as jax_fused_infonce
from cpc_tpu_torch.ops.infonce_allsteps_cuda import (allsteps_nll,
                                                     allsteps_nll_forward,
                                                     allsteps_nll_reference,
                                                     fused_infonce_allsteps)
from cpc_tpu_torch.ops.infonce_cuda import fused_infonce

FP32 = (None, None, 1e-4, 1e-7)
BF16 = (torch.bfloat16, jnp.bfloat16, 1e-2, 1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny tensors: one intra-op thread, so that parallel test workers do
    # not oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(B, T, K, D, C=None, seed=0):
    """preds_v (B, Tp, K, D) and z_pool (C, T, D), fp32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    preds_v = rng.standard_normal((B, T - K, K, D)).astype(np.float32)
    z = rng.standard_normal((C or B, T, D)).astype(np.float32)
    return preds_v, z


def _jax(preds_v, z, jcdt=None, shift=0):
    # through fused_infonce, which casts to the wire dtype and hands over to
    # fused_infonce_allsteps, as the training path does
    def f(p, zz):
        return jax_fused_infonce(p, zz, negatives="all_steps", shift=shift,
                                 compute_dtype=jcdt, interpret=True)
    with jax.default_matmul_precision("highest"):
        (loss, m), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(preds_v), jnp.asarray(z))
    return float(loss), np.asarray(m["acc"]), [np.asarray(x) for x in g]


def _port(preds_v, z, cdt=None, shift=0):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (preds_v, z)]
    loss, m = fused_infonce(*leaves, negatives="all_steps", shift=shift,
                            compute_dtype=cdt)
    loss.backward()
    return loss.item(), m["acc"].numpy(), [x.grad.numpy() for x in leaves]


def _assert_match(got, want, rtol, atol):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    for name, a, b in zip(("dpreds", "dz"), got[2], want[2]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("cdt,jcdt,rtol,atol", [FP32, BF16])
@pytest.mark.parametrize("B,T,K,D", [(4, 16, 3, 8), (3, 12, 2, 8),
                                     (8, 20, 12, 8)])
def test_loss_acc_and_gradients_match_jax(B, T, K, D, cdt, jcdt, rtol, atol):
    preds_v, z = _data(B, T, K, D, seed=17)
    _assert_match(_port(preds_v, z, cdt), _jax(preds_v, z, jcdt), rtol, atol)


@pytest.mark.parametrize("cdt,jcdt,rtol,atol", [FP32, BF16])
def test_ragged_rows_and_columns_with_a_shifted_pool_match_jax(
        cdt, jcdt, rtol, atol):
    # R = 17*3*3 = 153 rows and N = 6*20 = 120 columns: the JAX side pads
    # both to its tiles and masks; the port masks the ragged edges in place
    preds_v, z = _data(3, 20, 3, 40, C=6, seed=5)
    _assert_match(_port(preds_v, z, cdt, shift=3),
                  _jax(preds_v, z, jcdt, shift=3), rtol, atol)


def test_bf16_gradients_differ_from_fp32_ones_as_jax_s_do():
    # the bf16 rounding of delta is part of what is computed: against the
    # fp32 gradients the bf16 ones of both sides lie equally far
    preds_v, z = _data(4, 16, 3, 8, seed=17)
    # inputs already representable in bf16, so that only delta's and the
    # outputs' roundings separate the two wire dtypes
    preds_v, z = (torch.from_numpy(a).bfloat16().float().numpy()
                  for a in (preds_v, z))
    exact = _port(preds_v, z)[2]
    for got, want, ref in zip(_port(preds_v, z, torch.bfloat16)[2],
                              _jax(preds_v, z, jnp.bfloat16)[2], exact):
        scale = np.abs(ref).max()
        port_gap = np.abs(got - ref).max() / scale
        jax_gap = np.abs(want - ref).max() / scale
        assert 0 < port_gap < 1e-2 and 0 < jax_gap < 1e-2
        assert np.abs(got - want).max() / scale < 4e-3  # one rounding


def test_exact_ties_go_to_the_lowest_column_as_in_jax():
    # sequences 0 and 1 are the same latents, so column t (sequence 0) ties
    # with column T + t (sequence 1): sequence 1's positives lose
    preds_v, z = _data(4, 12, 3, 8, seed=11)
    z[1] = z[0]
    want, got = _jax(preds_v, z), _port(preds_v, z)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])


def test_ties_across_far_columns_keep_the_first():
    # a row that scores the same against every candidate: argmax 0
    preds_v, z = _data(2, 40, 2, 8, seed=2)
    z[:] = z[0, 0]
    nll, correct, _ = allsteps_nll_reference(torch.from_numpy(preds_v),
                                             torch.from_numpy(z), 0)
    assert correct.sum().item() == 0.0  # no positive sits at column 0
    np.testing.assert_allclose(nll.numpy(), np.log(2 * 40), rtol=1e-5)


@pytest.mark.parametrize("shift,C", [(0, 3), (2, 6)])
def test_random_cotangent_matches_jax_vjp(shift, C):
    B, T, K, D = 3, 11, 3, 8
    Tp = T - K
    R, N = Tp * K * B, C * T
    preds_v, z = _data(B, T, K, D, C=C, seed=7)
    g = np.random.default_rng(8).standard_normal(R).astype(np.float32)
    # the JAX wrapper's own flattening and row padding
    RT, _ = jp._tiles(R, N, D)
    pad = -(-R // RT) * RT - R
    p_flat = np.pad(preds_v.transpose(1, 2, 0, 3).reshape(R, D),
                    ((0, pad), (0, 0)))
    with jax.default_matmul_precision("highest"):
        (j_nll, j_cor), vjp = jax.vjp(
            lambda p, zz: jp.allsteps_nll(p, zz, jnp.asarray(shift, jnp.int32),
                                          B, K, T, True),
            jnp.asarray(p_flat), jnp.asarray(z.reshape(N, D)))
        j_dp, j_dz = vjp((jnp.asarray(np.pad(g, (0, pad))),
                          jnp.zeros_like(j_cor)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (preds_v, z)]
    nll, cor = allsteps_nll(*leaves, shift)
    torch.autograd.backward(nll, torch.from_numpy(g))
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(j_nll)[:R],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cor.numpy(), np.asarray(j_cor)[:R])
    # a cotangent of unit scale makes gradients of order 1 to 10, 1e4 times
    # those of the mean loss: the absolute floor scales with them
    want_dp = np.asarray(j_dp)[:R].reshape(Tp, K, B, D).transpose(2, 0, 1, 3)
    np.testing.assert_allclose(leaves[0].grad.numpy(), want_dp, rtol=1e-4,
                               atol=3e-6)
    np.testing.assert_allclose(leaves[1].grad.numpy(),
                               np.asarray(j_dz).reshape(C, T, D), rtol=1e-4,
                               atol=3e-6)


def test_plain_version_in_row_chunks_equals_one_chunk(monkeypatch):
    import cpc_tpu_torch.ops.infonce_allsteps_cuda as mod
    preds_v, z = _data(3, 14, 2, 8, seed=23)
    want = _port(preds_v, z)
    # 3 steps of K*B = 6 rows against N = 42 columns a chunk
    monkeypatch.setattr(mod, "PLAIN_SCORE_BYTES", 4 * 42 * 6 * 3)
    got = _port(preds_v, z)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2][0], want[2][0], rtol=0, atol=0)
    np.testing.assert_allclose(got[2][1], want[2][1], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("shift", [-1, 4])
def test_labels_outside_the_pool_raise(shift):
    preds_v, z = _data(3, 10, 3, 6, C=6)
    with pytest.raises(ValueError, match="outside the pool"):
        fused_infonce_allsteps(torch.from_numpy(preds_v),
                               torch.from_numpy(z), shift=shift)


def test_forward_on_cpu_is_the_reference_and_counts_no_launch():
    preds_v, z = map(torch.from_numpy, _data(3, 10, 3, 6))
    before = allsteps_nll_forward.launches
    for a, b in zip(allsteps_nll_forward(preds_v, z, 0),
                    allsteps_nll_reference(preds_v, z, 0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert allsteps_nll_forward.launches == before
