"""The port's GRU recurrence (cpc_tpu_torch/ops/gru_cuda.py) and GRU module
(cpc_tpu_torch/models/gru.py) against the JAX package.

On the CPU the JAX side runs the Pallas kernel in interpret mode
(`gru_scan(..., interpret=True)`, and `GRU(use_pallas=True)`, which picks
interpret mode off the TPU); the port runs `gru_scan_reference`. Inputs come
from a numpy seed; fp32 at 1e-5 (summation order only). The kernel itself
runs only on a GPU: tests/test_torch_port_cuda.py holds it against the
plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc_tpu.models.gru import GRU as JaxGRU
from cpc_tpu.ops.gru_pallas import gru_scan as jax_gru_scan
from cpc_tpu_torch.interop import gru_state_dict
from cpc_tpu_torch.models.gru import GRU
from cpc_tpu_torch.ops import gru_cuda
from cpc_tpu_torch.ops.gru_cuda import gru_scan, gru_scan_reference


def _scan_inputs(T, B, H, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, B, 3 * H)).astype(dtype),
            (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(dtype),
            (rng.standard_normal(3 * H) * 0.1).astype(dtype),
            rng.uniform(-0.9, 0.9, (B, H)).astype(np.float32))


def _jax_scan(args, dtype=jnp.float32):
    xp, wh, bh, h0 = args
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax_gru_scan(
            jnp.asarray(xp, dtype), jnp.asarray(wh, dtype),
            jnp.asarray(bh, dtype), jnp.asarray(h0), True).astype(jnp.float32))


@pytest.mark.parametrize("T,B,H", [(7, 3, 8), (9, 4, 16), (12, 2, 5),
                                   (1, 1, 4)])
def test_reference_matches_pallas_fp32(T, B, H):
    args = _scan_inputs(T, B, H, seed=T)
    got = gru_scan_reference(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == (T, B, H)
    np.testing.assert_allclose(got.numpy(), _jax_scan(args), rtol=0,
                               atol=1e-5)


def test_reference_matches_pallas_bf16():
    # bf16 wire: h rounded to bf16 for the product, fp32 gates and carry,
    # output rounded; differences are summation order moved across a bf16
    # rounding step, well under one output ulp (2**-8 near 1) on average
    args = _scan_inputs(11, 3, 16, seed=5)
    t = [torch.from_numpy(a) for a in args]
    got = gru_scan_reference(t[0].bfloat16(), t[1].bfloat16(),
                             t[2].bfloat16(), t[3])
    assert got.dtype == torch.bfloat16
    want = _jax_scan(args, jnp.bfloat16)
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 2e-2 and err.mean() <= 1e-3


def test_cpu_dispatch_is_reference_and_counts_no_launch():
    args = [torch.from_numpy(a) for a in _scan_inputs(5, 2, 8, seed=1)]
    before = gru_scan.launches
    torch.testing.assert_close(gru_scan(*args), gru_scan_reference(*args),
                               rtol=0, atol=0)
    assert gru_scan.launches == before


def test_reference_gradients_match_pallas_backward():
    # gru_scan on CPU tensors is differentiable (through _GruScanPlain);
    # its gradients agree with the JAX package's Pallas backward kernel
    # (interpret mode)
    T, B, H = 6, 3, 8
    args = _scan_inputs(T, B, H, seed=2)

    def jloss(xp, wh, bh, h0):
        hs = jax_gru_scan(xp, wh, bh, h0, True)
        return jnp.sum(hs * jnp.cos(hs))

    with jax.default_matmul_precision("highest"):
        jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    hs = gru_scan(*t)
    (hs * torch.cos(hs)).sum().backward()
    for name, a, g in zip(("xproj", "wh", "bh", "h0"), t, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def _bad_inputs():
    x, wh, bh, h0 = (torch.from_numpy(a) for a in _scan_inputs(4, 2, 8, 0))
    return {
        "xproj_2d": (x[0], wh, bh, h0),
        "xproj_not_3h": (x[..., :-1], wh, bh, h0),
        "fp16_wire": (x.half(), wh.half(), bh, h0),
        "wh_dtype": (x.bfloat16(), wh, bh, h0),
        "bh_dtype": (x, wh, bh.half(), h0),
        "h0_dtype": (x, wh, bh, h0.bfloat16()),
        "wh_shape": (x, wh[:-1], bh, h0),
        "bh_shape": (x, wh, bh[:-1], h0),
        "h0_shape": (x, wh, bh, h0[:1]),
        "xproj_strided": (x.transpose(0, 1).contiguous().transpose(0, 1),
                          wh, bh, h0),
        "wh_strided": (x, wh.T.contiguous().T, bh, h0),
        "empty": (x[:0], wh, bh, h0),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_kernel_wrapper_rejects(case):
    with pytest.raises((ValueError, TypeError)):
        gru_cuda._check(*_bad_inputs()[case])


def test_kernel_wrapper_accepts_both_wire_dtypes():
    x, wh, bh, h0 = (torch.from_numpy(a) for a in _scan_inputs(4, 2, 8, 0))
    gru_cuda._check(x, wh, bh, h0)
    gru_cuda._check(x.bfloat16(), wh.bfloat16(), bh.bfloat16(), h0)
    gru_cuda._check(x.bfloat16(), wh.bfloat16(), bh, h0)


def _gru_pair(D, H, L, seed):
    """JAX GRU(use_pallas=True) params made from a numpy seed, and the
    port's GRU with the same weights."""
    jgru = JaxGRU(hidden_size=H, num_layers=L, use_pallas=True)
    shapes = jax.eval_shape(jgru.init, jax.random.key(0),
                            jnp.zeros((1, 2, D)))["params"]
    rng = np.random.default_rng(seed)
    params = {"params": jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.4).astype(np.float32),
        shapes)}
    tgru = GRU(D, H, num_layers=L)
    tgru.load_state_dict(gru_state_dict(params["params"], L))
    return jgru, params, tgru


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("return_state,time_major_out,with_h0", [
    (False, False, False), (True, False, True), (True, True, False),
    (False, True, True)])
def test_gru_module_matches_jax_pallas(L, return_state, time_major_out,
                                       with_h0):
    B, T, D, H = 3, 9, 6, 8
    jgru, params, tgru = _gru_pair(D, H, L, seed=L)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = (rng.uniform(-0.9, 0.9, (L, B, H)).astype(np.float32)
          if with_h0 else None)
    kw = dict(return_state=return_state, time_major_out=time_major_out)
    with jax.default_matmul_precision("highest"):
        want = jgru.apply(params, jnp.asarray(x),
                          None if h0 is None else jnp.asarray(h0), **kw)
    got = tgru(torch.from_numpy(x),
               None if h0 is None else torch.from_numpy(h0), **kw)
    if not return_state:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5)


def test_gru_state_carry_continues_the_recurrence():
    # running [x1, x2] at once == x1, then x2 from x1's final state
    _, _, tgru = _gru_pair(4, 8, 2, seed=3)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 10, 4)).astype(np.float32))
    whole = tgru(x)
    first, state = tgru(x[:, :6], return_state=True)
    second = tgru(x[:, 6:], h0=state)
    torch.testing.assert_close(torch.cat([first, second], 1), whole,
                               rtol=0, atol=1e-6)
