"""The port's data feed against the JAX package's, on the CPU: `resample`
(`ops/dsp.py`), `decode_mono` and `SnippetDataset` over a 44.1 kHz FLAC
and WAV corpus, packed corpora (`data/packed.py`, `data/pack.py`) loading
across the two packages, the `dynamics` synthetic corpus,
`Batcher(yield_indices=True)` and `load_device_corpus`, and the eval CLI's
`--packed`.

Tolerances: the phase table bit for bit; a resampled signal within 1e-6 of
the JAX output's largest value (both sum the same 97 fp32 products, in
another order) and bit-equal across chunk sizes; int16 snippets of a
resampled file within 1 LSB, with the count of samples that differ
asserted (a sum that lands on the other side of a rounding boundary)."""

import json
import os

import numpy as np
import pytest
import torch

from cpc_tpu.data.dataset import ProbeDataset as JaxProbeDataset
from cpc_tpu.data.dataset import SnippetDataset as JaxSnippetDataset
from cpc_tpu.data.dataset import decode_mono as jax_decode_mono
from cpc_tpu.data.loader import Batcher as JaxBatcher
from cpc_tpu.data.loader import load_device_corpus as jax_load_device_corpus
from cpc_tpu.data.packed import PackedSnippetDataset as JaxPacked
from cpc_tpu.data.packed import pack_corpus as jax_pack_corpus
from cpc_tpu.data.synthetic import generate_synthetic_corpus as jax_generate
from cpc_tpu.ops import dsp as jax_dsp
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.data import pack
from cpc_tpu_torch.data.dataset import ProbeDataset, SnippetDataset
from cpc_tpu_torch.data.flac_encoder import write_flac
from cpc_tpu_torch.data.loader import Batcher, load_device_corpus
from cpc_tpu_torch.data.packed import PackedSnippetDataset, pack_corpus
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.data.wavio import decode_mono, read_wav
from cpc_tpu_torch.eval import cli as eval_cli
from cpc_tpu_torch.ops import dsp

SNIPPET = 2000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RATES = [(44_100, 16_000), (48_000, 16_000), (22_050, 16_000),
         (8_000, 16_000), (16_000, 44_100)]


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_resample_matches_jax_for_every_chunk_size(sr_in, sr_out,
                                                    monkeypatch):
    h, up, down = dsp._resample_kernel(sr_in, sr_out)
    jh, jup, jdown = jax_dsp._resample_kernel(sr_in, sr_out)
    assert (up, down) == (jup, jdown) and h.tobytes() == jh.tobytes()
    x = np.random.default_rng(sr_in).standard_normal((2, 3001)).astype(
        np.float32)
    want = np.asarray(jax_dsp.resample(x, sr_in, sr_out))
    outs = []
    for chunk_bytes in (1, 5_000, 100_000, dsp.RESAMPLE_CHUNK_BYTES):
        monkeypatch.setattr(dsp, "RESAMPLE_CHUNK_BYTES", chunk_bytes)
        outs.append(dsp.resample(torch.from_numpy(x), sr_in, sr_out).numpy())
    assert outs[0].shape == want.shape == (2, 3001 * up // down)
    for out in outs[1:]:
        assert out.tobytes() == outs[0].tobytes()
    np.testing.assert_allclose(outs[0], want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_resample_same_rate_is_identity():
    x = torch.randn(1, 100)
    assert dsp.resample(x, 16_000, 16_000) is x


@pytest.fixture(scope="module")
def corpus44(tmp_path_factory):
    """A 44.1 kHz speech corpus with phone labels: 3 speakers x 2 files of
    0.3 s, the first file of each speaker as FLAC (mono, stereo, stereo
    mid-side), the rest WAV."""
    root = str(tmp_path_factory.mktemp("corpus44"))
    paths = generate_synthetic_corpus(root, num_speakers=3,
                                      files_per_speaker=2,
                                      seconds_per_file=0.3,
                                      sample_rate=44_100, seed=2)
    for i, p in enumerate(paths[::2]):
        x, sr = read_wav(p)
        if i:
            x = np.concatenate([x, -0.5 * x], axis=1)
        write_flac(p[:-4] + ".flac", x, sr,
                   stereo_mode="mid_side" if i == 2 else "independent")
        os.remove(p)
    return root


def test_decode_mono_over_flac_and_wav_matches_jax(corpus44):
    ds = SnippetDataset(corpus44, SNIPPET, device="cpu")
    assert sum(f.endswith(".flac") for f in ds.files) == 3
    for path in ds.files:
        got, sr = decode_mono(path, 16_000, device="cpu")
        want, want_sr = jax_decode_mono(path, 16_000)
        assert sr == want_sr == 44_100 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_snippet_dataset_over_44k_matches_jax(corpus44):
    ours = SnippetDataset(corpus44, SNIPPET, 1500, device="cpu")
    theirs = JaxSnippetDataset(corpus44, SNIPPET, 1500)
    assert ours.files == theirs.files and len(ours) == len(theirs) == 12
    differ = 0
    for i in range(len(ours)):
        a = ours.snippet_int16(i).astype(np.int32)
        b = theirs.snippet_int16(i).astype(np.int32)
        assert np.abs(a - b).max(initial=0) <= 1
        differ += int((a != b).sum())
    # measured 0 of 24 000 samples (the sums agree bit for bit here)
    assert differ <= 24, f"{differ} of {len(ours) * SNIPPET} samples differ"


def test_probe_labels_are_remapped_across_rates(corpus44):
    ours = ProbeDataset(corpus44, SNIPPET, SNIPPET, device="cpu")
    theirs = JaxProbeDataset(corpus44, SNIPPET, SNIPPET)
    assert ours.num_speakers == theirs.num_speakers == 3
    for i in range(len(ours)):
        x, spk, ph = ours.item_with_labels(i)
        jx, jspk, jph = theirs.item_with_labels(i)
        assert spk == jspk and ph is not None
        np.testing.assert_array_equal(ph, jph)
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-6)


def test_packed_corpora_load_across_packages(corpus44, tmp_path):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert pack.main([corpus44, ours, "--device", "cpu"]) == 0
    jax_pack_corpus(corpus44, theirs, 16_000)
    with open(os.path.join(ours, "index.json")) as a, \
            open(os.path.join(theirs, "index.json")) as b:
        assert json.load(a) == json.load(b)
    for name in ("phones.u8", "data.i16"):
        a = np.fromfile(os.path.join(ours, name), np.uint8 if name.endswith(
            "u8") else "<i2").astype(np.int32)
        b = np.fromfile(os.path.join(theirs, name), np.uint8 if
                        name.endswith("u8") else "<i2").astype(np.int32)
        assert a.shape == b.shape and np.abs(a - b).max() <= (
            0 if name.endswith("u8") else 1)
    live = SnippetDataset(corpus44, SNIPPET, device="cpu")
    for packed_dir in (ours, theirs):  # each package reads both
        for ds in (PackedSnippetDataset(packed_dir, SNIPPET),
                   JaxPacked(packed_dir, SNIPPET)):
            assert len(ds) == len(live) and ds.num_speakers == 3
            assert [os.path.join(corpus44, f) for f in ds.files] == \
                live.files
            for i in range(len(ds)):
                assert np.abs(ds.snippet_int16(i).astype(np.int32)
                              - live.snippet_int16(i)).max() <= 1
    a, b = PackedSnippetDataset(ours, SNIPPET), JaxPacked(ours, SNIPPET)
    for i in range(len(a)):
        x, spk, ph = a.item_with_labels(i)
        jx, jspk, jph = b.item_with_labels(i)
        np.testing.assert_array_equal(x, jx)
        assert spk == jspk and a.speaker_of(i) == b.speaker_of(i)
        np.testing.assert_array_equal(ph, jph)
    with pytest.raises(ValueError, match="re-pack"):
        PackedSnippetDataset(ours, SNIPPET, sample_rate=8_000)


def test_pack_cli_needs_a_gpu_for_cuda(corpus44, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack.main([corpus44, str(tmp_path / "p")])


@pytest.mark.parametrize("seed,speakers,files", [(0, 3, 2), (7, 5, 1)])
def test_dynamics_corpus_is_bit_equal_to_jax(tmp_path, seed, speakers,
                                              files):
    kw = dict(style="dynamics", num_speakers=speakers,
              files_per_speaker=files, seconds_per_file=0.4, seed=seed)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_paths = jax_generate(a, **kw)
    paths = generate_synthetic_corpus(b, **kw)
    assert [os.path.relpath(p, b) for p in paths] == \
        [os.path.relpath(p, a) for p in jax_paths]
    for d, _, names in os.walk(a):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), a)
            with open(os.path.join(a, rel), "rb") as fa, \
                    open(os.path.join(b, rel), "rb") as fb:
                assert fa.read() == fb.read(), rel


def test_batcher_yields_jax_indices_and_resumes(tmp_path):
    root = str(tmp_path / "c")
    generate_synthetic_corpus(root, num_speakers=3, files_per_speaker=2,
                              seconds_per_file=0.5, seed=1)
    ds, jds = SnippetDataset(root, SNIPPET), JaxSnippetDataset(root, SNIPPET)
    ours = Batcher(ds, 2, seed=4, yield_indices=True)
    theirs = JaxBatcher(jds, 2, seed=4, yield_indices=True)
    n = 2 * ours.batches_per_epoch() + 1
    it, jit = iter(ours), iter(theirs)
    got = [next(it) for _ in range(n)]
    for (e, s, idx), (je, js, jidx) in zip(got, [next(jit) for _ in range(n)]):
        assert (e, s) == (je, js) and idx.dtype == jidx.dtype == np.int32
        np.testing.assert_array_equal(idx, jidx)
    assert ours.state() == theirs.state()
    # resume: a new Batcher restored from the state continues the order
    resumed = Batcher(ds, 2, seed=0, yield_indices=True)
    resumed.restore(ours.state())
    more = [next(it) for _ in range(3)]
    rit = iter(resumed)
    for (e, s, idx), (re_, rs, ridx) in zip(more, [next(rit)
                                                   for _ in range(3)]):
        assert (e, s) == (re_, rs)
        np.testing.assert_array_equal(idx, ridx)
    # the indices name the host batch's rows
    host = Batcher(ds, 2, seed=4)
    (_, _, batch), = [next(iter(host))]
    np.testing.assert_array_equal(
        batch, np.stack([ds.snippet_int16(int(i)) for i in got[0][2]]))
    for b in (ours, resumed, host):
        b.close()


def test_load_device_corpus_matches_jax_and_guards_its_budget(tmp_path):
    root = str(tmp_path / "c")
    generate_synthetic_corpus(root, num_speakers=2, files_per_speaker=1,
                              seconds_per_file=0.5, seed=3)
    ds = SnippetDataset(root, SNIPPET)
    corpus = load_device_corpus(ds, "cpu")
    want = np.asarray(jax_load_device_corpus(JaxSnippetDataset(root,
                                                               SNIPPET)))
    assert corpus.dtype == torch.int16 and corpus.shape == (len(ds), SNIPPET)
    np.testing.assert_array_equal(corpus.numpy(), want)
    budget = len(ds) * SNIPPET * 2 - 1
    with pytest.raises(ValueError) as ours:
        load_device_corpus(ds, "cpu", budget_bytes=budget)
    with pytest.raises(ValueError) as theirs:
        jax_load_device_corpus(JaxSnippetDataset(root, SNIPPET),
                               budget_bytes=budget)
    assert str(ours.value) == str(theirs.value)
    assert "HBM budget" in str(ours.value)


def test_eval_cli_probes_a_packed_corpus(tmp_path, capsys):
    root, packed = str(tmp_path / "c"), str(tmp_path / "p")
    generate_synthetic_corpus(root, num_speakers=3, files_per_speaker=2,
                              seconds_per_file=0.5, seed=0)
    pack_corpus(root, packed, device="cpu")
    workdir = tmp_path / "w"
    workdir.mkdir()
    cfg = tcfg.apply_overrides(tcfg.presets.tpu_fast(), [
        "model.encoder.channels=8,8,8,8,8", "model.encoder.d_enc=8",
        "model.ar.d_ar=8", "model.loss.prediction_steps=2",
        "model.dtype=float32", f"data.snippet_samples={SNIPPET * 2}"])
    (workdir / "config.json").write_text(json.dumps(tcfg.to_dict(cfg)))
    assert eval_cli.main(["--workdir", str(workdir), "--data", packed,
                          "--packed", "--device", "cpu", "--steps", "5",
                          "--max-snippets", "12"]) == 0
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    row = out[-1]
    assert row["checkpoint_step"] == 0
    for probe in ("speaker_probe", "phone_probe"):
        r = row[probe]
        assert 0.0 <= r["accuracy"] <= 1.0 and r["num_eval"] > 0
