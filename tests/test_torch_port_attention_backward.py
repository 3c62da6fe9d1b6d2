"""The port's whole attention backward (`flash_attention_backward`, plain
version: the CPU path) and the chooser of its kernels (`attention_route`),
against `cpc_tpu.ops.attention_pallas` in interpret mode on the same numpy
inputs.

Tolerances, as `test_torch_port_attention.py` states them:
  * fp32, p_dtype float32: dq, dk, dv 3e-5 absolute (entries are O(1); the
    TPU kernels fold tiles in with a running max where the plain version
    takes one softmax per row, so only fp32 rounding differs).
  * p_dtype bfloat16, and bf16 inputs: 1e-2 of the largest entry of the
    reference (P and dS rounded to bf16 relative to a running max on one
    side and to the row's max on the other; a bf16 output rounds once
    more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc_tpu.ops import attention_pallas as jattn
from cpc_tpu_torch.ops import attention_cuda as tattn

H, DH = 3, 8
LENGTHS = [24, 100, 128, 200]
# mode: (input dtype on either side, p_dtype)
MODES = {"fp32": (jnp.float32, torch.float32, "float32"),
         "p_bf16": (jnp.float32, torch.float32, "bfloat16"),
         "bf16_inputs": (jnp.bfloat16, torch.bfloat16, "float32"),
         "bf16_flash16": (jnp.bfloat16, torch.bfloat16, "bfloat16")}
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(T, B=2, seed=0):
    """q, k, v and a cotangent, (B, T, H, DH), distinct per head and row."""
    rng = np.random.default_rng(seed + T)
    return [rng.standard_normal((B, T, H, DH)).astype(np.float32)
            for _ in range(4)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _backward_args(arrays, tdt, p_dtype):
    """(q, k, v, do, lse, dres, scale, p_dtype) of the port's backward, lse
    and dres from its plain forward."""
    q, k, v, do = (_t(a, tdt) for a in arrays)
    scale = DH ** -0.5
    o, lse = tattn.flash_attention_forward_reference(q, k, v, scale, p_dtype)
    return q, k, v, do, lse, tattn.row_dot(do, o), scale, p_dtype


def _jax_grads(arrays, jdt, p_dtype):
    q, k, v, g = arrays

    def f(q, k, v):
        o = jattn.flash_causal_mha(q, k, v, p_dtype=p_dtype, interpret=True)
        # the cotangent as the port sees it: rounded to the wire dtype
        return jnp.sum(o.astype(jnp.float32)
                       * jnp.asarray(g, jdt).astype(jnp.float32))
    with jax.default_matmul_precision("highest"):
        grads = jax.grad(f, argnums=(0, 1, 2))(
            *(jnp.asarray(a, jdt) for a in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_backward_reference_is_the_two_references(T, mode):
    _, tdt, p_dtype = MODES[mode]
    args = _backward_args(_inputs(T), tdt, p_dtype)
    dq, dk, dv = tattn.flash_attention_backward_reference(*args)
    assert torch.equal(dq, tattn.flash_attention_dq_reference(*args))
    want_dk, want_dv = tattn.flash_attention_dkv_reference(*args)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
    for a in (dq, dk, dv):
        assert a.dtype == tdt and a.shape == (2, T, H, DH)
        assert a.is_contiguous()
    # a CPU tensor takes the plain version, and counts no launch
    before = tattn.flash_attention_backward.launches
    got = tattn.flash_attention_backward(*args)
    assert tattn.flash_attention_backward.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, (dq, dk, dv)))


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_backward_matches_jax(T, mode):
    jdt, tdt, p_dtype = MODES[mode]
    arrays = _inputs(T, seed=1)
    want = _jax_grads(arrays, jdt, p_dtype)
    got = tattn.flash_attention_backward(*_backward_args(arrays, tdt,
                                                         p_dtype))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(a.float().numpy() - w).max()
        if mode == "fp32":
            assert err <= 3e-5, (name, err)
        else:
            assert err / np.abs(w).max() <= 1e-2, (name, err)


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_function_backward_goes_through_it(T, p_dtype, monkeypatch):
    arrays = _inputs(T, seed=2)
    calls = []
    plain = tattn.flash_attention_backward_reference

    def spy(*args):
        calls.append(args)
        return plain(*args)
    # `_FlashPlain` holds the function it was made with: remake it
    monkeypatch.setattr(tattn, "_FlashPlain", tattn._flash_function(
        "_FlashPlain", tattn.flash_attention_forward_reference, spy))
    leaves = [_t(a).requires_grad_() for a in arrays[:3]]
    tattn.flash_causal_mha(*leaves, p_dtype=p_dtype).backward(_t(arrays[3]))
    assert len(calls) == 1 and calls[0][-1] == p_dtype
    want = plain(*_backward_args(arrays, torch.float32, p_dtype))
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_cuda_function_is_made_of_the_two_wrappers():
    # the halves a CUDA tensor takes: the forward wrapper, the whole backward
    q, k, v, do = (_t(a).requires_grad_() for a in _inputs(24))
    o = tattn._FlashCuda.apply(q, k, v, DH ** -0.5, "float32")
    o.backward(do.detach())  # CPU tensors: both wrappers take their plain side
    want = tattn.flash_causal_mha_backward_reference(
        q.detach(), k.detach(), v.detach(), o.detach(),
        tattn.flash_attention_forward_reference(q.detach(), k.detach(),
                                                v.detach(), DH ** -0.5)[1],
        do.detach())
    for leaf, w in zip((q, k, v), want):
        assert torch.equal(leaf.grad, w)


ROUTES = {
    # transformer_fast: one block a head, forward and backward
    "preset": ((64, 128, 8, 32, BF16, "bfloat16"),
               ("resident", "one_pass_resident", 0)),
    # T = 1 024: dQ of a head (128 KB fp32) still fits one block
    "long": ((16, 1024, 8, 32, BF16, "bfloat16"),
             ("tiled", "one_pass_resident", 0)),
    "long_few_heads": ((1, 1024, 4, 32, BF16, "bfloat16"),
                       ("tiled", "one_pass_split", 4)),
    "dq_does_not_fit": ((16, 2048, 8, 64, BF16, "bfloat16"),
                        ("tiled", "one_pass_split", 2)),
    "ragged": ((2, 200, 3, 16, BF16, "bfloat16"),
               ("tiled", "one_pass_split", 2)),
    "ragged_one_key_tile": ((2, 100, 3, 64, BF16, "bfloat16"),
                            ("resident", "one_pass_resident", 0)),
    "fp32_inputs": ((64, 128, 8, 32, torch.float32, "float32"),
                    ("simt", "pair", 0)),
    "fp32_inputs_bf16_p": ((64, 128, 8, 32, torch.float32, "bfloat16"),
                           ("simt", "pair", 0)),
    "fp32_p": ((64, 128, 8, 32, BF16, "float32"), ("exact", "pair", 0)),
    "head_dim_128": ((2, 256, 2, 128, BF16, "bfloat16"),
                     ("simt", "pair", 0)),
    "head_dim_24": ((2, 70, 3, 24, BF16, "bfloat16"), ("simt", "pair", 0)),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_attention_route_names_the_kernels(case):
    args, (forward, backward, groups) = ROUTES[case]
    route = tattn.attention_route(*args)
    assert (route.forward, route.backward, route.groups) == (forward,
                                                             backward, groups)
    B, T, H_, Dh = args[:4]
    if backward == "pair":
        return
    # a block's shared memory fits the card on the route taken
    assert tattn.one_pass_smem(T, Dh, resident=groups == 0) <= 232448
    assert groups <= -(-T // 128)
    # fewer SMs to fill: never more groups, and the same route
    small = tattn.attention_route(*args, sms=B * H_)
    assert small.backward == backward and small.groups <= groups


# what the library's launcher asks for on the card at these sizes
@pytest.mark.parametrize("T,Dh,resident,smem", [
    (128, 32, True, 95232), (1024, 32, True, 209920), (1024, 32, False, 78848),
    (128, 16, True, 70656),
    (200, 64, False, 111616)])
def test_one_pass_smem_counts_the_blocks_arrays(T, Dh, resident, smem):
    assert tattn.one_pass_smem(T, Dh, resident) == smem


@pytest.mark.parametrize("sms,groups", [(8, 2), (132, 4), (16, 2), (24, 3)])
def test_split_route_takes_the_groups_that_fill_the_card(sms, groups):
    route = tattn.attention_route(1, 1024, 8, 32, BF16, "bfloat16", sms=sms)
    assert (route.backward, route.groups) == ("one_pass_split", groups)


def test_attention_route_without_aligned_rows_is_the_pair():
    route = tattn.attention_route(64, 128, 8, 32, BF16, "bfloat16",
                                  aligned=False)
    assert (route.forward, route.backward) == ("simt", "pair")


@pytest.mark.parametrize("args,error", [
    ((2, 16, 2, 129, BF16, "bfloat16"), ValueError),   # Dh > 128
    ((2, 16, 2, 32, torch.float16, "float32"), TypeError),
    ((2, 0, 2, 32, BF16, "bfloat16"), ValueError),
    ((2, 16, 2, 32, BF16, "float16"), ValueError),
])
def test_attention_route_raises_where_no_kernel_takes_the_input(args, error):
    with pytest.raises(error):
        tattn.attention_route(*args)


def test_backward_wrapper_rejects_what_the_kernels_do_not_take():
    args = _backward_args(_inputs(24), torch.float32, "float32")
    with pytest.raises(ValueError, match="p_dtype"):
        tattn.flash_attention_backward(*args[:-1], "float16")
    with pytest.raises(ValueError, match="p_dtype"):
        tattn.flash_attention_backward_reference(*args[:-1], "float16")
