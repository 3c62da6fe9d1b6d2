"""The port's ConvEncoder (cpc_tpu_torch/models/encoder.py) against the flax
one, at the full kernels and strides (10, 8, 4, 4, 4) / (5, 4, 2, 2, 2) and
narrow channels, weights made from a numpy seed and carried across with
`encoder_state_dict`. fp32 at 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc_tpu.config import EncoderConfig as JaxEncoderConfig
from cpc_tpu.models.encoder import ConvEncoder as JaxConvEncoder
from cpc_tpu_torch.config import EncoderConfig
from cpc_tpu_torch.interop import encoder_state_dict
from cpc_tpu_torch.models.encoder import ConvEncoder, same_padding

NARROW = dict(channels=(16, 16, 16, 16, 16), d_enc=16)


def _pair(seed, **kw):
    jcfg = JaxEncoderConfig(**NARROW, **kw)
    jenc = JaxConvEncoder(jcfg)
    shapes = jax.eval_shape(jenc.init, jax.random.key(0),
                            jnp.zeros((1, 320)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "scale":  # LayerNorm scale around 1
            return (1 + 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if name == "kernel" else 10
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                ).astype(np.float32)

    params = {"params": jax.tree_util.tree_map_with_path(draw, shapes)}
    tcfg = EncoderConfig(**NARROW, **kw)
    tenc = ConvEncoder(tcfg)
    tenc.load_state_dict(encoder_state_dict(params["params"], tcfg))
    return jenc, params, tenc


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("norm", ["none", "layer"])
@pytest.mark.parametrize("samples", [2560, 2560 + 160 + 37])
def test_encoder_matches_flax(padding, norm, samples):
    jenc, params, tenc = _pair(seed=samples, padding=padding, norm=norm)
    x = np.random.default_rng(1).standard_normal((2, samples)
                                                 ).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jenc.apply)(params, jnp.asarray(x)))
    got = tenc(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("activation", ["gelu", "tanh"])
def test_encoder_activations_match_flax(activation):
    jenc, params, tenc = _pair(seed=3, activation=activation)
    x = np.random.default_rng(2).standard_normal((1, 2560)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jenc.apply)(params, jnp.asarray(x)))
    np.testing.assert_allclose(tenc(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=0, atol=1e-4)


def test_snippet_gives_128_latents():
    # SAME padding as flax computes it: 20480 samples -> 20480 // 160
    jenc, params, tenc = _pair(seed=0)
    x = np.random.default_rng(0).standard_normal((1, 20480, 1)
                                                 ).astype(np.float32)
    got = tenc(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (1, 128, 16)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jenc.apply)(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("t_in", [1, 5, 9, 20480, 4096, 4097, 1023])
@pytest.mark.parametrize("k,s", [(10, 5), (8, 4), (4, 2), (3, 1), (2, 4)])
def test_same_padding_matches_lax(t_in, k, s):
    lo_hi = jax.lax.padtype_to_pads((t_in,), (k,), (s,), "SAME")[0]
    assert same_padding(t_in, k, s) == tuple(lo_hi)


@pytest.mark.parametrize("kw", [dict(norm="group"), dict(norm="batch"),
                                dict(remat=True), dict(use_pallas=True)])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ConvEncoder(dataclasses.replace(EncoderConfig(**NARROW), **kw))


def test_unknown_norm_raises():
    with pytest.raises(ValueError, match="norm"):
        ConvEncoder(EncoderConfig(**NARROW, norm="bogus"))


@pytest.mark.parametrize("n", [2000, 2560, 3205])
def test_bf16_encoder_matches_jax_bf16_on_cpu(n):
    # bf16 compute: both round each conv's output to bf16 once. oneDNN's
    # bf16 conv1d on the CPU (torch 2.13) was off by up to 5 at outputs of
    # magnitude 5 for lengths divisible by the stride; the port runs CPU
    # bf16 convs in fp32 and rounds once. Bound: a few bf16 ulps (2**-8
    # relative) of the largest output, from rounding flips carried on.
    jenc, params, _ = _pair(seed=n)
    tenc = ConvEncoder(EncoderConfig(**NARROW), dtype=torch.bfloat16)
    tenc.load_state_dict(encoder_state_dict(params["params"],
                                            EncoderConfig(**NARROW)))
    jbf = JaxConvEncoder(JaxEncoderConfig(**NARROW), dtype=jnp.bfloat16)
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jbf.apply(params, jnp.asarray(x)).astype(
            jnp.float32))
    with torch.no_grad():
        got = tenc(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 3e-2 * max(1.0, np.abs(want).max())
