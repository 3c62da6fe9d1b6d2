"""The port's InfoNCE: the plain reference (`ops/infonce.py`) against
`cpc_tpu.ops.infonce.infonce_loss_and_metrics`, and the plain fused heads +
InfoNCE (`ops/infonce_fused.py`, the CPU path) against
`cpc_tpu.ops.infonce_fused.fused_heads_infonce` in interpret mode: loss,
per-k accuracy and the gradients of c, z and W; and that `use_pallas`
routes to the kernels' modules.

A cross-replica pool is the JAX side under shard_map on the virtual CPU
mesh (z all-gathered, labels shifted by axis_index * B); the port gets the
gathered pool and the shift as arguments. fp32 at 1e-5 relative, 1e-7
absolute (summation order). With compute_dtype=bf16 the inputs are rounded
to bf16 on both sides, the scores and softmax stay fp32, and the
gradients come out in bf16: 1e-2 relative, about one bf16 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cpc_tpu.ops.infonce import infonce_loss_and_metrics as jax_infonce
from cpc_tpu.ops.infonce_fused import fused_heads_infonce as jax_fused
from cpc_tpu.parallel.mesh import make_mesh
from cpc_tpu_torch.ops.infonce import first_argmax, infonce_loss_and_metrics
from cpc_tpu_torch.ops.infonce_fused import (fused_heads_infonce,
                                             heads_nll_forward,
                                             heads_nll_reference,
                                             validity_mask_tm)

B, T, K, D, A = 3, 10, 3, 6, 5
R = 2  # replicas of the cross-replica cases


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _mesh():
    return make_mesh((R,), ("data",), devices=jax.devices()[:R])


def _per_replica(fn, *arrays):
    """fn(*local arrays) -> (loss, acc) under shard_map over R replicas,
    returned per replica: (R,), (R, K)."""
    def local(*xs):
        loss, m = fn(*xs)
        return loss[None], m["acc"][None]
    out = jax.jit(jax.shard_map(
        local, mesh=_mesh(), in_specs=tuple(P("data") for _ in arrays),
        out_specs=(P("data"), P("data")), check_vma=False))
    with jax.default_matmul_precision("highest"):
        return [np.asarray(o) for o in out(*map(jnp.asarray, arrays))]


@pytest.mark.parametrize("negatives", ["same_step", "all_steps"])
def test_reference_matches_jax(negatives):
    preds, z = _rand((B, T, K, D), 0), _rand((B, T, D), 1)
    with jax.default_matmul_precision("highest"):
        jl, jm = jax_infonce(jnp.asarray(preds), jnp.asarray(z),
                             negatives=negatives)
    loss, m = infonce_loss_and_metrics(_t(preds), _t(z), negatives=negatives)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(m["acc"].numpy(), np.asarray(jm["acc"]),
                               atol=1e-6)
    np.testing.assert_allclose(m["acc_mean"].item(), float(jm["acc_mean"]),
                               atol=1e-6)


@pytest.mark.parametrize("negatives", ["same_step", "all_steps"])
def test_pool_and_shift_match_cross_replica_jax(negatives):
    preds, z = _rand((R * B, T, K, D), 2), _rand((R * B, T, D), 3)
    j_loss, j_acc = _per_replica(
        lambda p, zz: jax_infonce(p, zz, negatives=negatives,
                                  axis_name="data"), preds, z)
    for r in range(R):
        rows = slice(r * B, (r + 1) * B)
        loss, m = infonce_loss_and_metrics(
            _t(preds[rows]), _t(z[rows]), negatives=negatives, pool=_t(z),
            shift=r * B)
        np.testing.assert_allclose(loss.item(), j_loss[r], rtol=1e-5)
        np.testing.assert_allclose(m["acc"].numpy(), j_acc[r], atol=1e-6)


@pytest.mark.parametrize("negatives", ["same_step", "all_steps"])
def test_kernel_route_equals_plain_route_on_cpu(negatives):
    # use_pallas routes through ops.infonce_cuda (on the CPU, the kernels'
    # plain versions); 1e-5: summation order
    preds, z = _t(_rand((B, T, K, D), 0)), _t(_rand((2 * B, T, D), 1))
    want = infonce_loss_and_metrics(preds, z[B:], negatives=negatives,
                                    pool=z, shift=B)
    got = infonce_loss_and_metrics(preds, z[B:], negatives=negatives,
                                   pool=z, shift=B, use_pallas=True)
    bf16 = infonce_loss_and_metrics(preds, z[B:], negatives=negatives,
                                    pool=z, shift=B, use_pallas=True,
                                    pallas_bf16=True)
    np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=1e-5)
    np.testing.assert_allclose(got[1]["acc"].numpy(), want[1]["acc"].numpy(),
                               atol=1e-6)
    # the bf16 wire rounds the inputs: 2**-8 each, so 1e-2 on the loss
    np.testing.assert_allclose(bf16[0].item(), want[0].item(), rtol=1e-2)


def test_argmax_ties_go_to_the_first_maximum():
    s = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0],
                  [0.0, -1.0, 5.0, 5.0]], np.float32)
    np.testing.assert_array_equal(first_argmax(_t(s)).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(s), -1)))


def _fused_jax(c, z, W, compute_dtype, **kw):
    def f(c, z, W):
        return jax_fused(c, z, W, num_steps=K, compute_dtype=compute_dtype,
                         interpret=True, **kw)
    with jax.default_matmul_precision("highest"):
        (loss, m), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
            *map(jnp.asarray, (c, z, W)))
    return float(loss), np.asarray(m["acc"]), [np.asarray(x) for x in g]


def _fused_port(c, z, W, compute_dtype, **kw):
    leaves = [_t(a).requires_grad_() for a in (c, z, W)]
    loss, m = fused_heads_infonce(*leaves, num_steps=K,
                                  compute_dtype=compute_dtype, **kw)
    loss.backward()
    return loss.item(), m["acc"].numpy(), [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("cdt,jcdt,rtol,atol", [
    (None, None, 1e-5, 1e-7), (torch.bfloat16, jnp.bfloat16, 1e-2, 1e-4)])
@pytest.mark.parametrize("time_major", [False, True])
def test_fused_plain_matches_jax(cdt, jcdt, rtol, atol, time_major):
    c, z = _rand((B, T, A), 4), _rand((B, T, D), 5)
    W = _rand((A, K * D), 6, 0.5)
    c_in = c.transpose(1, 0, 2).copy() if time_major else c
    want = _fused_jax(c_in, z, W, jcdt, c_time_major=time_major)
    got = _fused_port(c_in, z, W, cdt, c_time_major=time_major)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    for name, a, b in zip(("dc", "dz", "dW"), got[2], want[2]):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def test_fused_pool_and_shift_match_cross_replica_jax():
    c, z = _rand((R * B, T, A), 7), _rand((R * B, T, D), 8)
    W = _rand((A, K * D), 9, 0.5)
    j_loss, j_acc = _per_replica(
        lambda cc, zz: jax_fused(cc, zz, jnp.asarray(W), num_steps=K,
                                 axis_name="data", interpret=True), c, z)
    for r in range(R):
        rows = slice(r * B, (r + 1) * B)
        loss, m = fused_heads_infonce(_t(c[rows]), _t(z[rows]), _t(W),
                                      num_steps=K, pool=_t(z), shift=r * B)
        np.testing.assert_allclose(loss.item(), j_loss[r], rtol=1e-5)
        np.testing.assert_allclose(m["acc"].numpy(), j_acc[r], atol=1e-6)


@pytest.mark.parametrize("shift", [-1, R * B - B + 1])
def test_fused_labels_outside_the_pool_raise(shift):
    c, z = _rand((B, T, A), 7), _rand((R * B, T, D), 8)
    with pytest.raises(ValueError, match="outside the pool"):
        fused_heads_infonce(_t(c), _t(z[:B]), _t(_rand((A, K * D), 9)),
                            num_steps=K, pool=_t(z), shift=shift)


def test_fused_argmax_ties_match_jax():
    # candidates 0 and 1 are the same latent at every step, so the scores
    # of columns 0 and 1 tie exactly: row 1's positive loses to column 0
    c, z = _rand((4, T, A), 10), _rand((4, T, D), 11)
    z[1] = z[0]
    W = _rand((A, K * D), 12, 0.5)
    want = _fused_jax(c, z, W, None)
    got = _fused_port(c, z, W, None)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])


def test_heads_forward_on_cpu_is_the_reference_and_counts_no_launch():
    p = _t(_rand((T, B, K * D), 13))
    zt = _t(_rand((T, B, D), 14))
    before = heads_nll_forward.launches
    for a, b in zip(heads_nll_forward(p, zt, 0, K),
                    heads_nll_reference(p, zt, 0, K)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert heads_nll_forward.launches == before
    mask = validity_mask_tm(T, K, B, T - K)
    assert mask.shape == (T, K * B) and mask.sum().item() == (T - K) * K * B
