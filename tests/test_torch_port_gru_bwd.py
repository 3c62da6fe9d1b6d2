"""The port's plain GRU backward (`gru_scan_backward_reference`, and
`_GruScanPlain`, the CPU path of `gru_scan`) against `jax.grad` of the JAX
package's Pallas `gru_scan` in interpret mode, whose backward is the Pallas
`_bwd_kernel`.

fp32 at 1e-5 (summation order only). bf16 (xproj, wh, bh and the output in
bf16, h0 fp32): dxproj, dwh and dbh come out in bf16, so the bound is 2e-3
absolute at gradients of magnitude about 2, about a quarter of one bf16 ulp
(2**-7 at 1..2): only a rare fp32 sum that lands next to a rounding edge may
flip. Autograd through the plain forward, as the port did before, missed it
by up to 7.8e-3 on these inputs: it rounds the recurrent gradient to bf16 at
every step and takes h_{t-1} from the fp32 carry, not from the rounded
outputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc_tpu.ops.gru_pallas import gru_scan as jax_gru_scan
from cpc_tpu_torch.ops.gru_cuda import (_GruScanPlain, gru_scan,
                                        gru_scan_backward,
                                        gru_scan_backward_reference,
                                        gru_scan_reference)

NAMES = ("dxproj", "dwh", "dbh", "dh0")


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, B, 3 * H)).astype(np.float32),
            (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32),
            (rng.standard_normal(3 * H) * 0.1).astype(np.float32),
            rng.uniform(-0.9, 0.9, (B, H)).astype(np.float32),
            rng.standard_normal((T, B, H)).astype(np.float32))


def _jax_grads(args, dtype):
    xp, wh, bh, h0, g = args

    def loss(xp, wh, bh, h0):
        hs = jax_gru_scan(xp, wh, bh, h0, True)
        return jnp.sum(hs.astype(jnp.float32) * g)

    with jax.default_matmul_precision("highest"):
        grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
            jnp.asarray(xp, dtype), jnp.asarray(wh, dtype),
            jnp.asarray(bh, dtype), jnp.asarray(h0))
    return [np.asarray(a.astype(jnp.float32)) for a in grads]


def _torch_args(args, dtype):
    xp, wh, bh, h0, g = (torch.from_numpy(a) for a in args)
    return xp.to(dtype), wh.to(dtype), bh.to(dtype), h0, g.to(dtype)


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 2e-3)])
@pytest.mark.parametrize("T,B,H", [(9, 3, 16), (6, 2, 8), (1, 1, 4)])
def test_backward_reference_matches_pallas(T, B, H, dtype, jdtype, tol):
    args = _inputs(T, B, H, seed=T + H)
    xp, wh, bh, h0, g = _torch_args(args, dtype)
    hs = gru_scan_reference(xp, wh, bh, h0)
    got = gru_scan_backward_reference(xp, wh, bh, h0, hs, g)
    assert [t.dtype for t in got] == [dtype, dtype, dtype, torch.float32]
    for name, a, want in zip(NAMES, got, _jax_grads(args, jdtype)):
        np.testing.assert_allclose(a.float().numpy(), want, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 2e-3)])
def test_autograd_through_gru_scan_matches_pallas(dtype, jdtype, tol):
    # gru_scan on CPU tensors runs _GruScanPlain: the same numbers reach
    # .grad through autograd, in the parameters' dtypes
    args = _inputs(9, 3, 16, seed=0)
    xp, wh, bh, h0, g = _torch_args(args, dtype)
    leaves = [t.clone().requires_grad_() for t in (xp, wh, bh, h0)]
    hs = gru_scan(*leaves)
    (hs.float() * g.float()).sum().backward()
    for name, t, want in zip(NAMES, leaves, _jax_grads(args, jdtype)):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.float().numpy(), want, rtol=0,
                                   atol=tol, err_msg=name)


def test_bf16_fault_of_autograd_through_the_plain_forward():
    # the fault the plain backward repairs: autograd through the plain
    # forward loop misses the Pallas backward by more than the bound above
    args = _inputs(9, 3, 16, seed=0)
    xp, wh, bh, h0, g = _torch_args(args, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (xp, wh, bh, h0)]
    (gru_scan_reference(*leaves).float() * g.float()).sum().backward()
    want = _jax_grads(args, jnp.bfloat16)
    worst = max(np.abs(t.grad.float().numpy() - w).max()
                for t, w in zip(leaves, want))
    assert worst > 2e-3


def test_plain_function_and_cpu_dispatch_count_no_launch():
    xp, wh, bh, h0, g = _torch_args(_inputs(5, 2, 8, seed=1), torch.float32)
    hs = gru_scan_reference(xp, wh, bh, h0)
    before = gru_scan_backward.launches
    got = gru_scan_backward(xp, wh, bh, h0, hs, g)
    want = gru_scan_backward_reference(xp, wh, bh, h0, hs, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert gru_scan_backward.launches == before
    leaves = [t.clone().requires_grad_() for t in (xp, wh, bh, h0)]
    torch.autograd.backward(_GruScanPlain.apply(*leaves), g)
    for a, b in zip(leaves, want):
        torch.testing.assert_close(a.grad, b, rtol=0, atol=0)
