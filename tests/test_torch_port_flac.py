"""The port's FLAC reader and writer (`cpc_tpu_torch/data/flac.py`, its
native decoder, `flac_encoder.py`) against the JAX package's, over the
matrix of tests/test_flac.py: subframe types, stereo modes, bit depths,
residual methods and partitions, escapes, wasted bits and odd tails.

For every case both encoders write the same bytes, both decoders return
the same samples bit for bit, and those samples are the written PCM: FLAC
is lossless. Corrupt input raises in both, never crashes the process, and
the two decoders agree on each corrupted buffer. Each file is a fraction
of a second of audio: the encoders write bit by bit in Python."""

import threading

import numpy as np
import pytest

from cpc_tpu.data.dataset import SnippetDataset as JaxSnippetDataset
from cpc_tpu.data.flac import flac_info as jax_flac_info
from cpc_tpu.data.flac import read_flac as jax_read_flac
from cpc_tpu.data.flac_encoder import write_flac as jax_write_flac
from cpc_tpu_torch.data import flac
from cpc_tpu_torch.data.dataset import SnippetDataset
from cpc_tpu_torch.data.flac import flac_info, read_flac
from cpc_tpu_torch.data.flac_encoder import write_flac


def _sig(n=3000, ch=1, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    base = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)
    if ch == 1:
        return base.astype(np.float32)
    other = 0.3 * np.sin(2 * np.pi * 660 * t) + 0.05 * rng.standard_normal(n)
    return np.stack([base, other], axis=1).astype(np.float32)


def _wasted():
    # 4 trailing zero bits in every sample: the wasted-bits header
    pcm = np.random.default_rng(3).integers(-1800, 1800, size=3000) << 4
    return (pcm / 32767.0).astype(np.float32)


# (name, signal, write_flac keywords): test_flac.py's matrix, each case
# once
CASES = (
    [(f"mono_{sf}", _sig(), dict(subframe=sf))
     for sf in ("verbatim", "fixed0", "fixed1", "fixed2", "fixed3",
                "fixed4", "lpc1", "lpc2", "lpc8", "lpc12")]
    + [("constant", np.full(4096, 0.25, np.float32),
        dict(subframe="constant"))]
    + [(f"stereo_{mode}_{sf}", _sig(ch=2), dict(stereo_mode=mode,
                                               subframe=sf))
       for mode in ("independent", "left_side", "right_side", "mid_side")
       for sf in ("fixed2", "lpc4")]
    + [(f"bps{bps}", _sig(n=2000), dict(bits_per_sample=bps))
       for bps in (8, 12, 16, 20, 24)]
    + [(f"stereo_{mode}_bps{bps}", _sig(n=1500, ch=2),
        dict(bits_per_sample=bps, stereo_mode=mode, subframe="lpc2",
             residual_method="rice2", partition_order=1, block_size=1024))
       for mode in ("left_side", "mid_side") for bps in (8, 16, 24)]
    + [(f"{method}_order{order}", _sig(n=4096),
        dict(subframe="lpc4", residual_method=method,
             partition_order=order, block_size=2048))
       for method in ("rice", "rice2") for order in (0, 2, 4)]
    + [("escape", _sig(n=2048), dict(subframe="fixed2", partition_order=3,
                                     escape_partitions=True,
                                     residual_method="rice2",
                                     block_size=2048)),
       ("wasted_bits", _wasted(), dict(subframe="lpc4", wasted_bits=True)),
       ("odd_tail", _sig(n=1024 + 333), dict(block_size=1024)),
       ("tail_partitions", _sig(n=1025), dict(subframe="fixed2",
                                              partition_order=2,
                                              block_size=1024)),
       ("lpc_precision_15", _sig(), dict(subframe="lpc8",
                                         lpc_precision=15))])


@pytest.mark.parametrize("name,sig,kw", CASES, ids=[c[0] for c in CASES])
def test_decoder_and_encoder_match_jax_bit_for_bit(tmp_path, name, sig, kw):
    port, jax_file = str(tmp_path / "port.flac"), str(tmp_path / "jax.flac")
    write_flac(port, sig, 44_100, **kw)
    jax_write_flac(jax_file, sig, 44_100, **kw)
    with open(port, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    got, sr = read_flac(port)
    want, want_sr = jax_read_flac(port)
    assert sr == want_sr == 44_100 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # lossless: the decoded samples are write_flac's quantized PCM
    bps = kw.get("bits_per_sample", 16)
    scale = (1 << (bps - 1)) - 1
    ref = sig if sig.ndim == 2 else sig[:, None]
    pcm = np.clip(np.round(ref * scale), -scale - 1, scale).astype(np.int64)
    np.testing.assert_array_equal(
        np.round(got.astype(np.float64) * (1 << (bps - 1))).astype(np.int64),
        pcm)
    assert flac_info(port) == jax_flac_info(port) == (len(ref), 44_100)


def test_flac_info_reads_unknown_totals_and_refuses_non_flac(tmp_path):
    p = str(tmp_path / "a.flac")
    write_flac(p, _sig(n=500), 16_000)
    data = bytearray(open(p, "rb").read())
    data[21] &= 0xF0  # STREAMINFO's 36-bit total: "unknown" (0)
    data[22:26] = b"\x00\x00\x00\x00"
    open(p, "wb").write(bytes(data))
    assert flac_info(p) == jax_flac_info(p) == (0, 16_000)
    # the decoder reads the frames whatever the header's total says, and
    # the dataset counts the file's snippets from a decode
    np.testing.assert_array_equal(read_flac(p)[0], jax_read_flac(p)[0])
    ds = SnippetDataset(str(tmp_path), 200, device="cpu")
    assert len(ds) == len(JaxSnippetDataset(str(tmp_path), 200)) == 2
    bad = tmp_path / "b.flac"
    bad.write_bytes(b"RIFF" + b"\x00" * 40)
    for info in (flac_info, jax_flac_info):
        with pytest.raises(ValueError, match="not a FLAC file"):
            info(str(bad))


def test_corrupt_input_raises_never_crashes(tmp_path):
    """Truncations, flipped bytes, a corrupt header and random payloads:
    each raises ValueError from both decoders or decodes to the same
    samples in both; none aborts the process. The first case is the maximal
    STREAMINFO total that once made an unchecked reserve throw through the
    C ABI."""
    rng = np.random.default_rng(7)
    good = tmp_path / "good.flac"
    write_flac(str(good), (rng.standard_normal(2000) * 8000).astype(
        np.int16)[:, None], 16_000)
    data = bytearray(good.read_bytes())
    huge = bytearray(data)
    huge[21] |= 0x0F
    huge[22:26] = b"\xff\xff\xff\xff"
    buffers = [bytes(huge)]
    for trial in range(120):
        buf = bytearray(data)
        mode = trial % 4
        if mode == 0:
            buf = buf[:rng.integers(4, len(buf))]
        elif mode == 1:
            for _ in range(rng.integers(1, 16)):
                buf[rng.integers(0, len(buf))] = rng.integers(0, 256)
        elif mode == 2:
            for _ in range(rng.integers(1, 6)):
                buf[rng.integers(0, min(64, len(buf)))] = rng.integers(0, 256)
        else:
            buf = bytearray(b"fLaC") + bytes(rng.integers(
                0, 256, rng.integers(10, 2000), dtype=np.uint8))
        buffers.append(bytes(buf))
    p = str(tmp_path / "bad.flac")
    raised = 0
    for buf in buffers:
        with open(p, "wb") as f:
            f.write(buf)
        outcomes = []
        for read in (read_flac, jax_read_flac):
            try:
                outcomes.append(read(p))
            except ValueError as e:
                outcomes.append(str(e))
        got, want = outcomes
        if isinstance(want, str):
            assert got == want
            raised += 1
        else:
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
    assert raised > len(buffers) // 2


def test_dataset_reads_flac_like_jax(tmp_path):
    d = tmp_path / "spk0" / "0"
    d.mkdir(parents=True)
    sig = _sig(n=8_000)
    write_flac(str(d / "utt0.flac"), sig, 16_000)
    write_flac(str(d / "utt1.flac"), _sig(n=6_000, ch=2, seed=1), 16_000,
               stereo_mode="mid_side")
    port = SnippetDataset(str(tmp_path), snippet_samples=2_000,
                          snippet_stride=1_500, device="cpu")
    jax_ds = JaxSnippetDataset(str(tmp_path), snippet_samples=2_000,
                               snippet_stride=1_500)
    assert port.files == jax_ds.files and len(port) == len(jax_ds) == 8
    for i in range(len(port)):
        np.testing.assert_array_equal(port[i], jax_ds[i])
        np.testing.assert_array_equal(port.snippet_int16(i),
                                      jax_ds.snippet_int16(i))
    np.testing.assert_allclose(port[0], sig[:2_000], atol=2 / 32768)


def test_build_is_keyed_and_a_failed_build_raises(tmp_path, monkeypatch):
    built = flac.build()
    assert built.parent == flac.BUILD_DIR and built.name.startswith(
        "flacdec-") and built == flac.library_path()
    # threads of one process building into an empty directory at once
    monkeypatch.setattr(flac, "BUILD_DIR", tmp_path / "build")
    out = []
    threads = [threading.Thread(target=lambda: out.append(flac.build()))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(set(out)) == 1 and out[0].exists()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == \
        [out[0].name]
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(flac, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="error"):
        flac.build()
    assert not any(p.name.endswith(".tmp.so")
                   for p in (tmp_path / "build").iterdir())
