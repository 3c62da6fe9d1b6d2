"""The port's host data (`cpc_tpu_torch/data/`, numpy copies) against the JAX
package's: the synthetic corpus is byte-identical from one seed, both build
the same snippet index over it, both Batchers give the same batches in the
same order, and `state`/`restore` resume exactly."""

import os

import numpy as np
import pytest
import torch

from cpc_tpu.data.dataset import SnippetDataset as JaxSnippetDataset
from cpc_tpu.data.loader import Batcher as JaxBatcher
from cpc_tpu.data.synthetic import generate_synthetic_corpus as jax_generate
from cpc_tpu.data.wavio import wav_info as jax_wav_info
from cpc_tpu_torch.data.dataset import SnippetDataset
from cpc_tpu_torch.data.loader import Batcher, device_prepare, to_device
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.data.wavio import wav_info, write_wav

KW = dict(num_speakers=3, files_per_speaker=2, seconds_per_file=1.3, seed=5)
SNIPPET = 4000


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("style", ["speech", "music"])
def test_synthetic_corpus_is_byte_identical(tmp_path, style):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_paths = jax_generate(a, style=style, **KW)
    paths = generate_synthetic_corpus(b, style=style, **KW)
    assert [os.path.relpath(p, b) for p in paths] == \
        [os.path.relpath(p, a) for p in jax_paths]
    fa, fb = _files(a), _files(b)
    assert fa.keys() == fb.keys() and fa == fb


def test_dynamics_style_waits(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        generate_synthetic_corpus(str(tmp_path), style="dynamics")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    generate_synthetic_corpus(root, **KW)
    return root


@pytest.mark.parametrize("stride", [None, 1500])
def test_same_snippet_index(corpus, stride):
    ja = JaxSnippetDataset(corpus, SNIPPET, stride)
    pa = SnippetDataset(corpus, SNIPPET, stride)
    assert len(pa) == len(ja) > 0
    assert pa.files == ja.files
    for i in range(len(pa)):
        assert pa.locate(i) == ja.locate(i)
        np.testing.assert_array_equal(pa.snippet_int16(i),
                                      ja.snippet_int16(i))
    np.testing.assert_array_equal(pa[len(pa) - 1], ja[len(ja) - 1])


def test_wav_info_and_write(tmp_path):
    x = np.sin(np.arange(1234) / 7.0).astype(np.float32) * 0.5
    write_wav(str(tmp_path / "a.wav"), np.stack([x, -x], 1), 22050)
    assert wav_info(str(tmp_path / "a.wav")) == \
        jax_wav_info(str(tmp_path / "a.wav")) == (1234, 22050)


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("shuffle,dtype", [(True, "int16"),
                                           (False, "float32")])
def test_batcher_matches_jax_across_epochs(corpus, shuffle, dtype):
    ds, jds = SnippetDataset(corpus, SNIPPET), JaxSnippetDataset(corpus,
                                                                  SNIPPET)
    kw = dict(shuffle=shuffle, seed=3, transfer_dtype=dtype)
    ours = Batcher(ds, 2, num_workers=2, **kw)
    theirs = JaxBatcher(jds, 2, **kw)
    n = 2 * ours.batches_per_epoch() + 1
    for (e, s, b), (je, js, jb) in zip(_take(iter(ours), n),
                                       _take(iter(theirs), n)):
        assert (e, s) == (je, js) and b.dtype == jb.dtype
        np.testing.assert_array_equal(b, jb)
    assert ours.state() == theirs.state()
    ours.close()


def test_batcher_state_restore_resumes_exactly(corpus):
    ds = SnippetDataset(corpus, SNIPPET)
    straight = Batcher(ds, 2, seed=1)
    want = [b for _, _, b in _take(iter(straight), 7)]
    first = Batcher(ds, 2, seed=1)
    got = [b for _, _, b in _take(iter(first), 4)]
    resumed = Batcher(ds, 2, seed=99)
    resumed.restore(first.state())
    got += [b for _, _, b in _take(iter(resumed), 3)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    val = [b for _, _, b in Batcher(ds, 2, shuffle=False).one_epoch()]
    assert len(val) == len(ds) // 2


def test_to_device_and_prepare_on_cpu():
    batch = (np.arange(12, dtype=np.int16).reshape(2, 6) - 6) * 1000
    t = to_device(batch, "cpu")
    assert t.dtype == torch.int16 and t.device.type == "cpu"
    x = device_prepare(t)
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.mean(-1).numpy(), 0, atol=1e-6)
