"""The port's streaming extractor (cpc_tpu_torch/eval/streaming.py) against
the JAX package's (cpc_tpu/eval/streaming.py), on the CPU in fp32 with the
JAX side at 'highest' matmul precision and the weights carried across by
`from_jax_params`.

The concatenated pushes must equal the port's own offline VALID forward
and JAX's StreamingExtractor fed the same chunks, at the JAX test's
tolerances (tests/test_streaming.py): rtol 1e-5 with atol 1e-5 on z, and
atol 1e-5 (GRU) or 2e-5 (transformer) on c; chunk sizes that do and do not
divide the pyramid's downsample factor, for both gars. Batched streams and
reset_stream follow tests/test_streaming.py's checklist.

The recurrence is `gru_scan`'s plain version here; on the card it is the
CUDA kernel, held at the streaming shapes by chip_smoke.py phase 21.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from cpc_tpu import config as jcfg
from cpc_tpu.eval import streaming as jstreaming
from cpc_tpu.models.cpc import CPCModel as JaxCPCModel
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.eval.streaming import (StreamingExtractor,
                                          portable_stream_model,
                                          receptive_field)
from cpc_tpu_torch.interop import from_jax_params
from cpc_tpu_torch.models.cpc import CPCModel

Z_TOL = dict(rtol=1e-5, atol=1e-5)
C_TOL = {"gru": dict(rtol=1e-5, atol=1e-5),
         "transformer": dict(rtol=1e-5, atol=2e-5)}
RESET_C_TOL = {"gru": dict(rtol=1e-6, atol=1e-6),
               "transformer": C_TOL["transformer"]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny tensors: one intra-op thread, so that parallel test workers do
    # not oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(num_layers=1, ar_kind="gru", **ar):
    return jcfg.ModelConfig(
        encoder=jcfg.EncoderConfig(kind="conv1d", channels=(24, 24, 24),
                                   kernels=(10, 8, 4), strides=(5, 4, 2),
                                   d_enc=24),
        ar=jcfg.ArConfig(kind=ar_kind, d_ar=16, num_layers=num_layers,
                         **ar))


@functools.lru_cache(maxsize=None)
def _pair(jmc, init_len=2000, dtype=None):
    """(JAX model, its params, the port's model with the same weights),
    made once a module for each config (no test changes either model)."""
    if dtype is not None:
        jmc = dataclasses.replace(jmc, dtype=dtype)
    jmodel = JaxCPCModel(jmc)
    # jitted: flax's eager init dispatches op by op (seconds)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  np.zeros((1, init_len), np.float32))
    tc = tcfg.from_dict(jcfg.to_dict(jcfg.CPCConfig(model=jmc)))
    model = CPCModel(tc.model)
    model.load_state_dict(from_jax_params(params, tc))
    return jmodel, params, model.eval()


def _offline(model, wave):
    """The port's offline VALID forward of one whole stream."""
    pm = portable_stream_model(model.config)
    pm.load_state_dict(model.state_dict())
    with torch.no_grad():
        z = pm.encode(torch.from_numpy(wave)[None])
        c = pm.gar(z)
    return z[0].numpy(), c[0].numpy()


def _feed(ex, wave, chunk):
    zs, cs = [], []
    for a in range(0, wave.shape[-1], chunk):
        z, c = ex.push(wave[..., a:a + chunk])
        zs.append(z)
        cs.append(c)
    return np.concatenate(zs, axis=-2), np.concatenate(cs, axis=-2)


def _wave(n, seed, rows=None):
    shape = (n,) if rows is None else (rows, n)
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("kernels,strides", [
    ((10, 8, 4, 4, 4), (5, 4, 2, 2, 2)), ((10, 8, 4), (5, 4, 2)),
    ((3,), (1,)), ((7, 5, 3), (3, 3, 1))])
def test_receptive_field_matches_jax(kernels, strides):
    assert receptive_field(kernels, strides) == \
        jstreaming.receptive_field(kernels, strides)
    if kernels == (10, 8, 4, 4, 4):
        assert receptive_field(kernels, strides) == (465, 160)


@pytest.mark.parametrize("enc", [dict(kind="scalogram"), dict(norm="group"),
                                 dict(norm="batch")])
def test_rejections_match_jax(enc):
    jmc = _jax_cfg()
    jmc = dataclasses.replace(jmc, encoder=dataclasses.replace(jmc.encoder,
                                                               **enc))
    tmc = tcfg.from_dict(jcfg.to_dict(jcfg.CPCConfig(model=jmc))).model
    with pytest.raises(ValueError) as want:
        jstreaming.portable_stream_model(jmc)
    with pytest.raises(ValueError) as got:
        portable_stream_model(tmc)
    assert str(got.value) == str(want.value)


@functools.lru_cache(maxsize=None)
def _jax_stream(num_layers=1, ar_kind="gru", n=8321, seed=4):
    """JAX's StreamingExtractor over a seeded wave in one push (its output
    does not depend on the chunking: tests/test_streaming.py), made once a
    module; with the wave and the port's model on the same weights."""
    jmodel, params, model = _pair(_jax_cfg(num_layers, ar_kind,
                                           **_HEADS[ar_kind]))
    wave = _wave(n, seed)
    with jax.default_matmul_precision("highest"):
        jz, jc = jstreaming.StreamingExtractor(jmodel, params).push(wave)
    return model, wave, jz, jc


_HEADS = {"gru": {}, "transformer": {"num_heads": 2}}


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("chunk", [160, 1001, 4000])
def test_gru_stream_equals_offline_and_jax(num_layers, chunk):
    model, wave, jz, jc = _jax_stream(num_layers)
    ex = StreamingExtractor(model)
    z_s, c_s = _feed(ex, wave, chunk)
    z_off, c_off = _offline(model, wave)
    assert z_s.shape == z_off.shape == ((8321 - 105) // 40 + 1, 24)  # rf 105
    assert z_s.dtype == np.float32
    np.testing.assert_allclose(z_s, z_off, **Z_TOL)
    np.testing.assert_allclose(c_s, c_off, **C_TOL["gru"])
    np.testing.assert_allclose(z_s, jz, **Z_TOL)
    np.testing.assert_allclose(c_s, jc, **C_TOL["gru"])
    # reset() restarts the stream identically
    ex.reset()
    z2, c2 = ex.push(wave)
    np.testing.assert_allclose(z2, z_off, **Z_TOL)
    np.testing.assert_allclose(c2, c_off, **C_TOL["gru"])


def test_short_push_emits_nothing_and_keeps_the_samples():
    _, _, model = _pair(_jax_cfg())
    ex = StreamingExtractor(model)
    z, c = ex.push(_wave(100, seed=1))  # rf 105: no latent yet
    assert z.shape == (0, 24) and c.shape == (0, 16)
    assert ex.pending_samples == 100
    ex3 = StreamingExtractor(model, n_streams=3)
    z, c = ex3.push(_wave(100, seed=2, rows=3))
    assert z.shape == (3, 0, 24) and c.shape == (3, 0, 16)


def test_stats_normalize_and_reject_bad_values():
    jmodel, params, model = _pair(_jax_cfg())
    wave = (np.random.default_rng(4).standard_normal(2000)).astype(np.float32)
    z, _ = StreamingExtractor(model, stats=(0.1, 2.0)).push(wave)
    z_off, _ = _offline(model, (wave - np.float32(0.1)) / np.float32(2.0))
    np.testing.assert_allclose(z, z_off, **Z_TOL)
    with jax.default_matmul_precision("highest"):
        jz, _ = jstreaming.StreamingExtractor(jmodel, params,
                                              stats=(0.1, 2.0)).push(wave)
    np.testing.assert_allclose(z, jz, **Z_TOL)
    for bad in [(0.0, 0.0), (0.0, -1.0), (float("nan"), 1.0),
                (0.0, float("inf"))]:
        with pytest.raises(ValueError, match="finite positive std"):
            StreamingExtractor(model, stats=bad)


@pytest.mark.parametrize("chunk", [160, 1001])
def test_transformer_stream_equals_offline_and_jax(chunk):
    model, wave, jz, jc = _jax_stream(ar_kind="transformer", n=4321, seed=7)
    ex = StreamingExtractor(model)
    z_s, c_s = _feed(ex, wave, chunk)
    z_off, c_off = _offline(model, wave)
    assert c_s.shape == c_off.shape == jc.shape
    np.testing.assert_allclose(z_s, z_off, **Z_TOL)
    np.testing.assert_allclose(c_s, c_off, **C_TOL["transformer"])
    np.testing.assert_allclose(z_s, jz, **Z_TOL)
    np.testing.assert_allclose(c_s, jc, **C_TOL["transformer"])
    ex.reset()
    _, c2 = ex.push(wave)
    np.testing.assert_allclose(c2, c_off, **C_TOL["transformer"])


def test_transformer_max_len_raises_where_jax_does():
    jmodel, params, model = _pair(_jax_cfg(ar_kind="transformer",
                                           num_heads=2, max_len=16),
                                  init_len=600)
    wave = _wave(4321, seed=7)
    ex = StreamingExtractor(model)
    jex = jstreaming.StreamingExtractor(jmodel, params)
    # 14 latents fit; the next push's 3 more cross 16 in both packages
    first = 105 + 13 * 40
    assert ex.push(wave[:first])[1].shape == (14, 16)
    jex.push(wave[:first])
    with pytest.raises(ValueError, match="max_len"):
        jex.push(wave[first:first + 120])
    with pytest.raises(ValueError, match="max_len") as got:
        ex.push(wave[first:first + 120])
    assert "17 latents > max_len 16" in str(got.value)


def test_flash_trained_checkpoint_streams_on_the_xla_twin():
    # the extractor pins its offline twin to attn_impl='xla' (the same
    # parameters); the flash model's own forward agrees to its tolerance
    model = CPCModel(tcfg.ModelConfig(
        encoder=tcfg.EncoderConfig(channels=(16, 24), kernels=(10, 8),
                                   strides=(5, 4), d_enc=24),
        ar=tcfg.ArConfig(kind="transformer", d_ar=16, num_layers=1,
                         num_heads=2, attn_impl="flash")),
        generator=torch.Generator().manual_seed(0)).eval()
    wave = _wave(3000, seed=11)
    z_s, c_s = StreamingExtractor(model).push(wave)
    z_off, c_off = _offline(model, wave)
    np.testing.assert_allclose(c_s, c_off, **C_TOL["transformer"])
    flash = dataclasses.replace(model.config, encoder=dataclasses.replace(
        model.config.encoder, padding="VALID"), dtype="float32")
    fm = CPCModel(flash)
    fm.load_state_dict(model.state_dict())
    with torch.no_grad():
        c_fl = fm.gar(fm.encode(torch.from_numpy(wave)[None]))[0].numpy()
    np.testing.assert_allclose(c_s, c_fl, rtol=1e-4, atol=1e-4)


def test_bf16_model_streams_in_fp32():
    jmc = jcfg.ModelConfig(
        encoder=jcfg.EncoderConfig(channels=(16, 16), kernels=(10, 8),
                                   strides=(5, 4), d_enc=16),
        ar=jcfg.ArConfig(d_ar=8, use_pallas=True))
    jmodel, params, model = _pair(jmc, dtype="bfloat16")
    assert model.dtype == torch.bfloat16
    wave = (np.random.default_rng(5).standard_normal(3000)
            ).astype(np.float32)
    ex = StreamingExtractor(model)
    z_s, c_s = _feed(ex, wave, 877)
    assert z_s.dtype == c_s.dtype == np.float32
    z_off, c_off = _offline(model, wave)
    np.testing.assert_allclose(z_s, z_off, **Z_TOL)
    np.testing.assert_allclose(c_s, c_off, **C_TOL["gru"])
    with jax.default_matmul_precision("highest"):
        jz, jc = jstreaming.StreamingExtractor(jmodel, params).push(wave)
    np.testing.assert_allclose(z_s, jz, **Z_TOL)
    np.testing.assert_allclose(c_s, jc, **C_TOL["gru"])


def test_push_runs_with_tf32_off_and_restores_the_settings(monkeypatch):
    _, _, model = _pair(_jax_cfg())
    ex = StreamingExtractor(model)
    seen = []
    encode = ex._model.encode

    def spy(x):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return encode(x)

    monkeypatch.setattr(ex._model, "encode", spy)
    kept = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        ex.push(_wave(1000, seed=1))
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = kept
    assert seen == [(False, False)]
    assert after == (True, True)


@pytest.mark.parametrize("ar_kind", ["gru", "transformer"])
def test_batched_streams_equal_offline(ar_kind):
    _, _, model = _pair(_jax_cfg(ar_kind=ar_kind, num_heads=2))
    waves = _wave(4000, seed=9, rows=3)
    ex = StreamingExtractor(model, n_streams=3)
    z_s, c_s = _feed(ex, waves, 1001)
    for i in range(3):
        z_off, c_off = _offline(model, waves[i])
        np.testing.assert_allclose(z_s[i], z_off, **Z_TOL)
        np.testing.assert_allclose(c_s[i], c_off, **C_TOL[ar_kind])
    with pytest.raises(ValueError, match="chunk must be"):
        ex.push(waves[:2, :100])
    with pytest.raises(ValueError, match="n_streams"):
        StreamingExtractor(model, n_streams=0)


@pytest.mark.parametrize("ar_kind", ["gru", "transformer"])
def test_reset_stream_recycles_one_row(ar_kind):
    """reset_stream(i): the recycled row equals a FRESH extractor fed
    zeros(len(residual)) + the later chunks, and the other rows are
    bit-identical to a run that never reset (tests/test_streaming.py)."""
    _, _, model = _pair(_jax_cfg(ar_kind=ar_kind, num_heads=2))
    rng = np.random.default_rng(11)
    waves = (rng.standard_normal((3, 4000)) * 0.3).astype(np.float32)
    new_wave = (rng.standard_normal(2100) * 0.3).astype(np.float32)
    before, after = [(0, 900), (900, 1900)], [(1900, 2800), (2800, 4000)]

    ref = StreamingExtractor(model, n_streams=3)
    ref_out = [ref.push(waves[:, a:b]) for a, b in before + after]

    ex = StreamingExtractor(model, n_streams=3)
    for a, b in before:
        ex.push(waves[:, a:b])
    resid_len = ex.pending_samples
    ex.reset_stream(1)
    post, feed = [], []
    for a, b in after:
        chunk = waves[:, a:b].copy()
        chunk[1] = new_wave[a - 1900:b - 1900]   # row 1 is a NEW stream
        feed.append(chunk[1])
        post.append(ex.push(chunk))
    for k, (z, c) in enumerate(post):
        z_ref, c_ref = ref_out[len(before) + k]
        for row in (0, 2):
            np.testing.assert_array_equal(z[row], z_ref[row])
            np.testing.assert_array_equal(c[row], c_ref[row])

    fresh = StreamingExtractor(model)
    first = np.concatenate([np.zeros(resid_len, np.float32), feed[0]])
    fz, fc = _feed_chunks(fresh, [first] + feed[1:])
    np.testing.assert_allclose(np.concatenate([p[0][1] for p in post]), fz,
                               rtol=1e-6, atol=1e-6)
    # the fresh extractor runs a batch of 1, the recycled row a batch of 3:
    # the transformer's CPU matmuls block by batch (measured 2.0e-6 on c),
    # so its c is held at the stream's own tolerance
    np.testing.assert_allclose(np.concatenate([p[1][1] for p in post]), fc,
                               **RESET_C_TOL[ar_kind])
    with pytest.raises(ValueError, match="out of range"):
        ex.reset_stream(3)


def _feed_chunks(ex, chunks):
    outs = [ex.push(c) for c in chunks]
    return (np.concatenate([o[0] for o in outs]),
            np.concatenate([o[1] for o in outs]))


def test_portable_model_shares_the_parameter_tree():
    tmc = tcfg.presets.tpu_fast().model
    pm = portable_stream_model(tmc)
    assert pm.config.encoder.padding == "VALID"
    assert pm.config.dtype == "float32"
    assert not pm.config.encoder.use_pallas and not pm.config.ar.use_pallas
    assert {k: v.shape for k, v in pm.state_dict().items()} == \
        {k: v.shape for k, v in CPCModel(tmc).state_dict().items()}
    tr = tcfg.presets.transformer_fast().model
    tr = dataclasses.replace(tr, ar=dataclasses.replace(
        tr.ar, attn_impl="flash16"))
    assert portable_stream_model(tr).config.ar.attn_impl == "xla"
