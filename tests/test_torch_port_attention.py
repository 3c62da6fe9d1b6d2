"""The port's causal attention (`cpc_tpu_torch.ops.attention_cuda`, plain
versions: the CPU path) against `cpc_tpu.ops.attention_pallas` in interpret
mode, on the same numpy inputs.

Tolerances:
  * fp32, p_dtype float32: o 2e-5, dq/dk/dv 3e-5 absolute (entries are O(1);
    the TPU kernel folds tiles in with a running max where the plain version
    takes one softmax per row, so only fp32 rounding differs).
  * p_dtype bfloat16, and bf16 inputs: 1e-2 of the largest entry of the
    reference. P and dS are rounded to bf16 (2**-9 relative each) relative
    to a running max on one side and to the row's max on the other, and a
    bf16 output rounds once more (2**-9 of an entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc_tpu.ops import attention_pallas as jattn
from cpc_tpu_torch.ops import attention_cuda as tattn

H = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(T, B=2, Dh=8, seed=0, n=3):
    """n arrays (B, T, H, Dh), distinct per head and batch row."""
    rng = np.random.default_rng(seed + T)
    return [rng.standard_normal((B, T, H, Dh)).astype(np.float32)
            for _ in range(n)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _jax_fwd(q, k, v, p_dtype="float32", dtype=jnp.float32):
    with jax.default_matmul_precision("highest"):
        o = jattn.flash_causal_mha(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                   p_dtype=p_dtype)
    return np.asarray(o.astype(jnp.float32))


def _jax_grads(q, k, v, g, p_dtype="float32", dtype=jnp.float32):
    def f(q, k, v):
        o = jattn.flash_causal_mha(q, k, v, p_dtype=p_dtype)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(g))
    with jax.default_matmul_precision("highest"):
        grads = jax.grad(f, argnums=(0, 1, 2))(
            *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


@pytest.mark.parametrize("T", [24, 100, 128, 200, 300])
def test_forward_matches_jax_fp32(T):
    q, k, v = _qkv(T)
    want = _jax_fwd(q, k, v)
    got = tattn.flash_causal_mha(_t(q), _t(k), _t(v))
    assert got.shape == (2, T, H, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    ref = tattn.flash_causal_mha_reference(_t(q), _t(k), _t(v))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("T", [100, 200])
def test_backward_matches_jax_fp32(T):
    q, k, v, g = _qkv(T, n=4)  # a non-uniform cotangent
    want = _jax_grads(q, k, v, g)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    tattn.flash_causal_mha(*leaves).backward(_t(g))
    for name, leaf, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0, atol=3e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("T", [100, 200])
@pytest.mark.parametrize("mode", ["p_bf16", "bf16_inputs", "bf16_flash16"])
def test_reduced_precision_matches_jax(T, mode):
    # within 1e-2 of the largest entry: see the module docstring
    p_dtype = "float32" if mode == "bf16_inputs" else "bfloat16"
    jdt, tdt = ((jnp.float32, torch.float32) if mode == "p_bf16"
                else (jnp.bfloat16, torch.bfloat16))
    q, k, v, g = _qkv(T, n=4)
    want_o = _jax_fwd(q, k, v, p_dtype, jdt)
    want_g = _jax_grads(q, k, v, g, p_dtype, jdt)
    leaves = [_t(a, tdt).requires_grad_() for a in (q, k, v)]
    o = tattn.flash_causal_mha(*leaves, p_dtype=p_dtype)
    assert o.dtype == tdt
    o.float().backward(_t(g))
    for name, got, want in [("o", o.detach(), want_o)] + [
            (f"d{n}", leaf.grad, w) for n, leaf, w in zip("qkv", leaves,
                                                          want_g)]:
        assert got.dtype == tdt
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-2, (name, err)


@pytest.mark.parametrize("T", [24, 200])
def test_lse_matches_the_jax_forward(T):
    q, k, v = _qkv(T, B=1)
    scale = 8 ** -0.5

    def fold(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(H, T, 8)
    with jax.default_matmul_precision("highest"):
        jo, (_, _, _, jlse) = jattn._flash_fwd(fold(q), fold(k), fold(v),
                                               scale, True, "float32")
    jlse = np.asarray(jlse).reshape(H, -1)[:, :T]
    o, lse = tattn.flash_attention_forward(_t(q), _t(k), _t(v), scale)
    assert lse.shape == (1, H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse[0].numpy(), jlse, rtol=0, atol=2e-5)
    # the folded form of the plain forward is the same function
    fo, flse = tattn.flash_forward_folded_reference(
        *(_t(np.asarray(fold(a))) for a in (q, k, v)), scale)
    np.testing.assert_allclose(fo.numpy(), np.asarray(jo), rtol=0, atol=2e-5)
    assert torch.equal(flse, lse[0])


def test_causality_is_exact():
    q, k, v = (_t(a) for a in _qkv(70))
    t = 40
    base = tattn.flash_causal_mha(q, k, v)
    q2, k2, v2 = (a.clone() for a in (q, k, v))
    for a in (q2, k2, v2):
        a[:, t + 1:] += 3.0
    changed = tattn.flash_causal_mha(q2, k2, v2)
    assert torch.equal(base[:, :t + 1], changed[:, :t + 1])
    assert not torch.equal(base[:, t + 1:], changed[:, t + 1:])


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_function_gradient_is_the_explicit_backward(p_dtype):
    q, k, v, g = (_t(a) for a in _qkv(50, n=4))
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    o = tattn.flash_causal_mha(*leaves, p_dtype=p_dtype)
    o.backward(g)
    _, lse = tattn.flash_attention_forward_reference(q, k, v, 8 ** -0.5,
                                                     p_dtype)
    want = tattn.flash_causal_mha_backward_reference(
        q, k, v, o.detach(), lse, g, p_dtype=p_dtype)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_explicit_backward_is_the_derivative_of_the_forward():
    # in fp32 the explicit formulas equal autograd through the plain forward
    q, k, v, g = (_t(a).double() for a in _qkv(40, n=4))
    leaves = [a.clone().float().requires_grad_() for a in (q, k, v)]
    tattn.flash_causal_mha(*leaves).backward(g.float())
    auto = [a.clone().requires_grad_() for a in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", auto[0], auto[1]) * 8 ** -0.5
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(), -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), auto[2])
    o.backward(g)
    for leaf, a in zip(leaves, auto):
        np.testing.assert_allclose(leaf.grad.numpy(), a.grad.numpy(), rtol=0,
                                   atol=2e-5)


def test_non_default_scale_and_strided_heads():
    # q, k, v as slices of one fused projection: strided, last axis dense
    rng = np.random.default_rng(5)
    qkv = _t(rng.standard_normal((2, 30, 3, H, 8)))
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = tattn.flash_causal_mha(q, k, v, scale=0.2)
    with jax.default_matmul_precision("highest"):
        want = jattn.flash_causal_mha(*(jnp.asarray(a.numpy())
                                        for a in (q, k, v)), scale=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v = (_t(a) for a in _qkv(10))
    with pytest.raises(ValueError, match="p_dtype"):
        tattn.flash_causal_mha(q, k, v, p_dtype="float16")
    for bad in ((q[0], k, v), (q.half(), k.half(), v.half()),
                (q, k[:, :5], v), (q, k, v.double()),
                (q.transpose(2, 3).contiguous().transpose(2, 3), k, v)):
        with pytest.raises((ValueError, TypeError)):
            tattn._check(*bad)
    wide = torch.zeros(1, 4, 1, tattn.MAX_HEAD_DIM + 1)
    with pytest.raises(ValueError, match="Dh <="):
        tattn._check(wide, wide, wide)
    lse = torch.zeros(2, H, 10)
    tattn._check(q, k, v, do=q, lse=lse, dres=lse)
    with pytest.raises(ValueError, match="lse"):
        tattn._check(q, k, v, do=q, lse=lse[:, :, :5], dres=lse)
