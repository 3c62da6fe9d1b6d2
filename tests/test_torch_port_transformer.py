"""The port's `CausalTransformer` against `cpc_tpu.models.transformer` with
the same parameters (numpy draws, carried across by
`interop.transformer_state_dict`), for every ported `attn_impl`.

The JAX side runs 'flash' and 'flash16' through its Pallas kernels in
interpret mode, at `jax.default_matmul_precision('highest')`.

Tolerances: fp32 output 3e-5 and parameter gradients 5e-5 absolute
(summation order through two blocks). Under 'flash16' in an fp32 model P and
V are rounded to bf16 (2**-9 relative), P relative to a running max on the
JAX side and to the row's max here: output 2e-3 absolute, gradients 3e-2
absolute (1.2e-2 measured on entries up to 36; the key bias's true gradient is zero, a shift
of every key leaves the softmax as it was, so what it holds is this
rounding noise, 5.5e-3 measured). bf16
compute: output within 2e-2 of the largest entry of JAX's (measured 1.1e-2
to 1.6e-2; JAX's own bf16 output lies 0.8e-2 to 1.4e-2 from its fp32
output): both sides round activations to bf16 at the same points, but a
value that lands one bf16 ulp (2**-8 relative) apart carries on through the
blocks and the final LayerNorm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc_tpu import config as jcfg
from cpc_tpu.models import transformer as jtr
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.interop import transformer_state_dict
from cpc_tpu_torch.models import transformer as ttr

D_IN, T, B = 12, 40, 3
IMPLS = ("xla", "flash", "flash16")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ar(impl="xla", **kw):
    kw = dict(kind="transformer", d_ar=16, num_layers=2, num_heads=4,
              mlp_ratio=2, max_len=64, attn_impl=impl, **kw)
    return jcfg.ArConfig(**kw), tcfg.ArConfig(**kw)


def _params(jar, seed=0):
    """JAX params from a numpy seed: nonzero biases, scales around 1."""
    shapes = jax.eval_shape(jtr.CausalTransformer(jar).init,
                            jax.random.key(0),
                            jnp.zeros((1, 8, D_IN)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "pos_embed":
            return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = s.shape[0] if len(s.shape) < 3 or path[-2].key != "out" \
            else s.shape[0] * s.shape[1]
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                ).astype(np.float32)
    return {"params": jax.tree_util.tree_map_with_path(draw, shapes)}


def _z(seed=1, t=T):
    return np.random.default_rng(seed).standard_normal((B, t, D_IN)
                                                       ).astype(np.float32)


def _torch_model(tar, params, dtype=torch.float32):
    model = ttr.CausalTransformer(D_IN, tar, dtype=dtype)
    model.load_state_dict(transformer_state_dict(params["params"], tar, D_IN))
    return model


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_gradients_match_jax_fp32(impl):
    jar, tar = _ar(impl)
    params, z = _params(jar), _z()
    g = np.random.default_rng(2).standard_normal((B, T, 16)).astype(np.float32)
    jmodel = jtr.CausalTransformer(jar)

    def f(p, z):
        return jnp.sum(jmodel.apply(p, z) * g)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmodel.apply(params, jnp.asarray(z)))
        jgp, jgz = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(z))
    model = _torch_model(tar, params)
    zt = torch.from_numpy(z).requires_grad_()
    got = model(zt)
    tol_o, tol_g = (3e-5, 5e-5) if impl != "flash16" else (2e-3, 3e-2)

    def close(a, b, tol, name):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)

    close(got.detach().numpy(), want, tol_o, "c")
    got.backward(torch.from_numpy(g))
    close(zt.grad.numpy(), np.asarray(jgz), tol_g, "dz")
    want_g = transformer_state_dict(jax.tree.map(np.asarray, jgp)["params"],
                                    tar, D_IN)
    assert set(want_g) == {k for k, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        w = want_g[name].numpy()
        if name == "pos_embed":  # rows beyond T get no gradient
            assert np.abs(w[T:]).max() == 0 and p.grad[T:].abs().max() == 0
        close(p.grad.numpy(), w, tol_g, name)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax_bf16(impl):
    # within 2e-2 of the largest entry: see the module docstring
    jar, tar = _ar(impl)
    params, z = _params(jar, seed=3), _z(seed=4)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jtr.CausalTransformer(jar, dtype=jnp.bfloat16).apply(
            params, jnp.asarray(z)).astype(jnp.float32))
        want32 = np.asarray(jtr.CausalTransformer(jar).apply(
            params, jnp.asarray(z)))
    model = _torch_model(tar, params, torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(z))
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got = got.float().numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 2e-2, err
    # and as close to JAX's fp32 output as that
    err32 = np.abs(got - want32).max() / np.abs(want32).max()
    assert err32 <= 2e-2, err32


def test_one_state_dict_loads_under_every_impl():
    jar, tar = _ar()
    params, z = _params(jar, seed=5), torch.from_numpy(_z(seed=6))
    sd = _torch_model(tar, params).state_dict()
    outs = []
    for impl in IMPLS:
        model = ttr.CausalTransformer(D_IN, dataclasses.replace(
            tar, attn_impl=impl))
        model.load_state_dict(sd)
        with torch.no_grad():
            outs.append(model(z))
    # the impls differ in where the scale is applied; flash16 also rounds
    # P and V to bf16 (2**-9 relative; 6.5e-3 at the output, entries to 3.7)
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=3e-5)
    torch.testing.assert_close(outs[2], outs[0], rtol=0, atol=1e-2)
    assert not torch.equal(outs[2], outs[1])


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_gives_equal_gradients(impl):
    jar, tar = _ar(impl)
    params, z = _params(jar, seed=7), torch.from_numpy(_z(seed=8))
    grads = []
    for remat in (False, True):
        model = _torch_model(dataclasses.replace(tar, remat=remat), params)
        model(z).square().sum().backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        assert torch.equal(grads[1][k], g), k


@pytest.mark.parametrize("stacked", [False, True])
def test_decode_step_matches_offline_forward_and_jax(stacked):
    jar, tar = _ar("xla")
    params, z = _params(jar, seed=9), _z(seed=10, t=12)
    jdec = jtr.carry_decode_model(jar)
    dec = ttr.carry_decode_model(D_IN, tar)
    dec.load_state_dict(transformer_state_dict(params["params"], tar, D_IN))
    with torch.no_grad():
        offline = _torch_model(tar, params)(torch.from_numpy(z))
    jcarry = jtr.decode_carry(jar, B)
    carry = ttr.decode_carry(tar, B)
    assert isinstance(carry["k"], tuple) and carry["k"][0].shape == \
        (B, 64, 4, 4) and carry["pos"].dtype == torch.int64
    if stacked:
        jcarry = {"k": jnp.stack(jcarry["k"]), "v": jnp.stack(jcarry["v"]),
                  "pos": jcarry["pos"]}
        carry = {"k": torch.stack(carry["k"]), "v": torch.stack(carry["v"]),
                 "pos": carry["pos"]}
    step = jax.jit(lambda c, zt: jdec.apply(
        params, zt, c, method=jtr.CausalTransformer.decode_step))
    reset_at, row = 7, 1
    for t in range(12):
        if t == reset_at:  # stream `row` restarts; the others carry on
            jcarry["pos"] = jcarry["pos"].at[row].set(0)
            carry["pos"] = carry["pos"].clone()
            carry["pos"][row] = 0
        with jax.default_matmul_precision("highest"):
            jc, jcarry = step(jcarry, jnp.asarray(z[:, t]))
        with torch.no_grad():
            c, carry = dec.decode_step(torch.from_numpy(z[:, t]), carry)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0,
                                   atol=3e-5)
        assert isinstance(carry["k"], torch.Tensor if stacked else tuple)
        np.testing.assert_array_equal(carry["pos"].numpy(),
                                      np.asarray(jcarry["pos"]))
        if t < reset_at:
            np.testing.assert_allclose(c.numpy(), offline[:, t].numpy(),
                                       rtol=0, atol=3e-5)
    # after its reset the stream equals an offline forward from there on
    with torch.no_grad():
        tail = _torch_model(tar, params)(torch.from_numpy(z[row:row + 1,
                                                            reset_at:]))
    np.testing.assert_allclose(c[row].numpy(), tail[0, -1].numpy(), rtol=0,
                               atol=3e-5)


def test_decode_step_needs_the_explicit_projection_module():
    _, tar = _ar("xla")
    model = ttr.CausalTransformer(D_IN, tar)
    with pytest.raises(ValueError, match="carry_decode_model"):
        model.decode_step(torch.zeros(B, D_IN), ttr.decode_carry(tar, B))


@pytest.mark.parametrize("kw,exc,match", [
    (dict(attn_impl="fast"), ValueError, "attn_impl must be"),
    (dict(attn_impl="flash", dropout=0.1), ValueError, "dropout"),
    (dict(attn_impl="flash16", dropout=0.1), ValueError, "dropout"),
    (dict(attn_impl="ring"), NotImplementedError, "§A13"),
    (dict(attn_impl="zigzag"), NotImplementedError, "§A13"),
    (dict(num_heads=5), ValueError, "not divisible"),
])
def test_validation_errors(kw, exc, match):
    _, tar = _ar()
    with pytest.raises(exc, match=match):
        ttr.CausalTransformer(D_IN, dataclasses.replace(tar, **kw))


def test_sequence_longer_than_max_len_raises():
    _, tar = _ar()
    with pytest.raises(ValueError, match="max_len"):
        ttr.CausalTransformer(D_IN, tar)(torch.zeros(1, 65, D_IN))


def test_jax_raises_the_same_validation_errors():
    # the messages' key words are the JAX package's
    for kw, match in ((dict(attn_impl="fast"), "attn_impl must be"),
                      (dict(attn_impl="flash", dropout=0.1), "dropout")):
        jar = dataclasses.replace(_ar()[0], **kw)
        with pytest.raises(ValueError, match=match):
            jtr.CausalTransformer(jar).init(jax.random.key(0),
                                            jnp.zeros((1, 8, D_IN)))


def _dropout_model(rate=0.25, remat=False):
    jar, tar = _ar("xla", dropout=rate, remat=remat)
    return _torch_model(tar, _params(jar, seed=11)), \
        _torch_model(dataclasses.replace(tar, dropout=0.0),
                     _params(jar, seed=11))


def test_dropout_is_off_without_train_and_repeats_with_a_seed():
    dropped, plain = _dropout_model()
    z = torch.from_numpy(_z(seed=12))
    with torch.no_grad():
        assert torch.equal(dropped(z), plain(z))
        assert torch.equal(dropped(z, train=False,
                                   generator=torch.Generator()), plain(z))
        a = dropped(z, True, torch.Generator().manual_seed(3))
        b = dropped(z, True, torch.Generator().manual_seed(3))
        c = dropped(z, True, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, plain(z))
    with pytest.raises(ValueError, match="Generator"):
        dropped(z, train=True)


def test_dropout_keeps_its_share():
    # 40 000 draws at p = 0.25: the kept share lies within 4 standard
    # deviations (4 * sqrt(p (1 - p) / n) = 0.0087) of 1 - p
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200, 200)
    y = ttr.dropout(x, 0.25, True, gen)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) <= 0.0087
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    mask = ttr.keep_mask((1, 1, 200, 200), 0.25, "cpu", gen)
    assert abs(mask.float().mean().item() - 0.75) <= 0.0087


def test_remat_replays_the_dropout_draws():
    z = torch.from_numpy(_z(seed=13))
    grads = []
    for remat in (False, True):
        model, _ = _dropout_model(remat=remat)
        out = model(z, True, torch.Generator().manual_seed(5))
        out.square().sum().backward()
        grads.append((out.detach(), {k: p.grad for k, p in
                                     model.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for k, g in grads[0][1].items():
        assert torch.equal(grads[1][1][k], g), k
