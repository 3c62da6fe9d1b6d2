"""The port's numpy WAV decode (cpc_tpu_torch/data/wavio.py) against the
JAX package's `read_wav` / `decode_mono` on the same files; `decode_mono`
also over FLAC and across rates."""

import struct

import numpy as np
import pytest

from cpc_tpu.data import wavio as jwavio
from cpc_tpu.data.dataset import decode_mono as jax_decode_mono
from cpc_tpu.data.flac_encoder import write_flac as jax_write_flac
from cpc_tpu_torch.data import wavio


def _write(path, payload: bytes, fmt_code: int, channels: int, bits: int,
           rate: int = 16000, extensible: bool = False):
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt_code,
                      channels, rate, rate * block, block, bits)
    if extensible:  # cbSize, valid bits, channel mask, SubFormat GUID
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack(
            "<H", fmt_code) + b"\x00" * 14
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8
                                      + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)


def _payload(kind, n, channels, rng):
    x = rng.uniform(-0.9, 0.9, n * channels)
    if kind == "pcm8":
        return np.round(x * 127 + 128).astype(np.uint8).tobytes(), 1, 8
    if kind == "pcm16":
        return np.round(x * 32767).astype("<i2").tobytes(), 1, 16
    if kind == "pcm24":
        v = np.round(x * (2 ** 23 - 1)).astype("<i4").view(np.uint8)
        return v.reshape(-1, 4)[:, :3].tobytes(), 1, 24
    if kind == "pcm32":
        return np.round(x * (2 ** 31 - 1)).astype("<i4").tobytes(), 1, 32
    if kind == "float32":
        return x.astype("<f4").tobytes(), 3, 32
    return x.astype("<f8").tobytes(), 3, 64


@pytest.mark.parametrize("kind", ["pcm8", "pcm16", "pcm24", "pcm32",
                                  "float32", "float64"])
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_matches_jax(kind, channels, tmp_path):
    payload, code, bits = _payload(kind, 333, channels,
                                   np.random.default_rng(channels))
    path = str(tmp_path / "a.wav")
    _write(path, payload, code, channels, bits, extensible=channels == 2)
    got, sr = wavio.read_wav(path)
    want, want_sr = jwavio.read_wav(path)
    assert sr == want_sr == 16000 and got.shape == want.shape == (333,
                                                                  channels)
    np.testing.assert_array_equal(got, want)
    mono, _ = wavio.decode_mono(path, 16000)
    np.testing.assert_array_equal(mono, jax_decode_mono(path, 16000)[0])


def test_decode_mono_refuses_what_waits(tmp_path):
    # FLAC and resampling, which raised before the data feed was ported,
    # now decode: an 8 kHz WAV and a stereo 22.05 kHz FLAC at 16 kHz, on
    # the CPU, against the JAX package's decode_mono
    rng = np.random.default_rng(4)
    wav, flac = str(tmp_path / "a.wav"), str(tmp_path / "b.flac")
    jwavio.write_wav(wav, rng.uniform(-0.5, 0.5, 800).astype(np.float32),
                     8000)
    jax_write_flac(flac, rng.uniform(-0.5, 0.5, (441, 2)).astype(np.float32),
                   22050)
    for path, rate in ((wav, 8000), (flac, 22050)):
        got, sr = wavio.decode_mono(path, 16000, device="cpu")
        want, want_sr = jax_decode_mono(path, 16000)
        assert sr == want_sr == rate and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="no decoder"):
        wavio.decode_mono(str(tmp_path / "a.mp3"), 16000, device="cpu")


def test_not_a_wav_raises(tmp_path):
    path = tmp_path / "a.wav"
    path.write_bytes(b"not a riff file at all")
    with pytest.raises(ValueError, match="RIFF"):
        wavio.read_wav(str(path))
