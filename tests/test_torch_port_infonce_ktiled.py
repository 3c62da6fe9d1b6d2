"""The port's same-step InfoNCE on materialized predictions
(`ops/infonce_cuda.py`, on the CPU its plain versions) against
`cpc_tpu.ops.infonce_pallas` with its Pallas kernels in interpret mode at
`jax.default_matmul_precision('highest')`: loss, per-k accuracy, and the
gradients of preds_v and of the pool.

Tolerances. fp32: 1e-5 relative (1e-7 absolute on gradients): the two sides
differ in summation order only. bf16 wire (`compute_dtype=bfloat16`): both
sides round preds_v and the pool to bf16, score and take the softmax in
fp32, keep delta in fp32 and round the two gradients to bf16 once, so the
loss stays at 1e-5 and a gradient may land one bf16 rounding (2**-8) apart:
1e-2 relative, 1e-4 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpc_tpu.ops.infonce_pallas as jp
from cpc_tpu_torch.ops.infonce_cuda import (fused_infonce,
                                            fused_same_step_nll,
                                            same_step_nll_forward,
                                            same_step_nll_reference,
                                            validity_mask)

FP32 = (None, None, 1e-5, 1e-7)
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
    def f(p, zz):
        return jp.fused_infonce(p, zz, shift=shift, compute_dtype=jcdt,
                                interpret=True)
    with jax.default_matmul_precision("highest"):
        (loss, m), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(preds_v), jnp.asarray(z))
    return float(loss), np.asarray(m["acc"]), [np.asarray(x) for x in g]


def _port(preds_v, z, cdt=None, shift=0):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (preds_v, z)]
    loss, m = fused_infonce(*leaves, shift=shift, compute_dtype=cdt)
    loss.backward()
    return loss.item(), m["acc"].numpy(), [x.grad.numpy() for x in leaves]


def _assert_match(got, want, rtol, atol):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    for name, a, b in zip(("dpreds", "dz"), got[2], want[2]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("cdt,jcdt,rtol,atol", [FP32, BF16])
@pytest.mark.parametrize("B,T,K,D", [(4, 16, 3, 8), (3, 10, 4, 16),
                                     (8, 20, 12, 8)])
def test_loss_acc_and_gradients_match_jax(B, T, K, D, cdt, jcdt, rtol, atol):
    preds_v, z = _data(B, T, K, D)
    _assert_match(_port(preds_v, z, cdt), _jax(preds_v, z, jcdt), rtol, atol)


@pytest.mark.parametrize("cdt,jcdt,rtol,atol", [FP32, BF16])
def test_shifted_positives_in_a_larger_pool_match_jax(cdt, jcdt, rtol, atol):
    # the ragged shape: no extent is a multiple of a tile
    preds_v, z = _data(3, 20, 3, 40, C=6, seed=5)
    _assert_match(_port(preds_v, z, cdt, shift=3),
                  _jax(preds_v, z, jcdt, shift=3), rtol, atol)


def test_matches_jax_where_it_tiles_k(monkeypatch):
    # a VMEM budget under which the JAX side splits K into KT = 2 tiles and
    # sums dz over them; the port has no such split
    B, T, K, D = 128, 12, 2, 16
    monkeypatch.setattr(jp, "_VMEM_BUDGET", 300_000)
    assert jp._choose_kt(K, B, B, D, 4) == 2
    preds_v, z = _data(B, T, K, D, seed=13)
    _assert_match(_port(preds_v, z), _jax(preds_v, z), 1e-5, 1e-7)


def test_exact_ties_go_to_the_first_maximum_as_in_jax():
    # candidates 0 and 1 are the same latent at every step, so columns 0 and
    # 1 tie exactly: row 1's positive loses to column 0
    preds_v, z = _data(4, 12, 3, 8, seed=11)
    z[1] = z[0]
    want, got = _jax(preds_v, z), _port(preds_v, z)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    assert 0.0 < got[1].mean() < 1.0


@pytest.mark.parametrize("shift,C", [(0, 4), (2, 7)])
def test_random_cotangent_matches_jax_vjp(shift, C):
    B, T, K, D = 4, 11, 3, 8
    Tp = T - K
    preds_v, z = _data(B, T, K, D, C=C, seed=7)
    g = np.random.default_rng(8).standard_normal((T - 1, K * B)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        (j_nll, j_cor), vjp = jax.vjp(
            lambda p, zz: jp.fused_same_step_nll(
                p, zz, jnp.asarray(shift, jnp.int32), True),
            jnp.asarray(preds_v.transpose(1, 2, 0, 3)),
            jnp.asarray(z.transpose(1, 0, 2)))
        j_dp, j_dz = vjp((jnp.asarray(g), jnp.zeros_like(j_cor)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (preds_v, z)]
    nll, cor = fused_same_step_nll(*leaves, shift)
    torch.autograd.backward(nll, torch.from_numpy(g))
    mask = np.asarray(jp.validity_mask(T, K, B, Tp))
    np.testing.assert_array_equal(validity_mask(T, K, B, Tp).numpy(), mask)
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(j_nll) * mask,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cor.numpy(), np.asarray(j_cor) * mask)
    # a cotangent of unit scale makes gradients of order 1 to 10, 1e4 times
    # those of the mean loss: the absolute floor scales with them (softmax
    # as exp(s - lse) here, e / sum(e) there)
    np.testing.assert_allclose(leaves[0].grad.numpy(),
                               np.asarray(j_dp).transpose(2, 0, 1, 3),
                               rtol=1e-5, atol=3e-6)
    np.testing.assert_allclose(leaves[1].grad.numpy(),
                               np.asarray(j_dz).transpose(1, 0, 2),
                               rtol=1e-5, atol=3e-6)
    assert leaves[1].grad[:, 0].abs().max().item() == 0.0  # never a target


def test_preds_may_be_the_window_of_a_longer_array():
    # the training path hands over preds[:, :Tp] uncopied in fp32
    B, T, K, D = 3, 10, 2, 8
    rng = np.random.default_rng(3)
    preds = torch.from_numpy(rng.standard_normal((B, T, K, D)).astype(
        np.float32)).requires_grad_()
    z = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    loss, _ = fused_infonce(preds[:, :T - K], z)
    loss.backward()
    want = _jax(preds.detach().numpy()[:, :T - K], z.numpy())
    np.testing.assert_allclose(loss.item(), want[0], rtol=1e-5)
    np.testing.assert_allclose(preds.grad[:, :T - K].numpy(), want[2][0],
                               rtol=1e-5, atol=1e-7)
    assert preds.grad[:, T - K:].abs().max().item() == 0.0


@pytest.mark.parametrize("shift", [-1, 4])
def test_labels_outside_the_pool_raise(shift):
    preds_v, z = _data(3, 10, 3, 6, C=6)
    with pytest.raises(ValueError, match="outside the pool"):
        fused_infonce(torch.from_numpy(preds_v), torch.from_numpy(z),
                      shift=shift)


def test_shapes_that_do_not_fit_raise():
    preds_v, z = _data(3, 10, 3, 6)
    with pytest.raises(ValueError, match="Tp = T - K"):
        fused_infonce(torch.from_numpy(preds_v[:, :-1]), torch.from_numpy(z))
    with pytest.raises(ValueError, match="unknown negatives"):
        fused_infonce(torch.from_numpy(preds_v), torch.from_numpy(z),
                      negatives="next_step")


def test_forward_on_cpu_is_the_reference_and_counts_no_launch():
    preds_v, z = map(torch.from_numpy, _data(3, 10, 3, 6))
    before = same_step_nll_forward.launches
    for a, b in zip(same_step_nll_forward(preds_v, z, 0),
                    same_step_nll_reference(preds_v, z, 0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert same_step_nll_forward.launches == before
