"""Snippet datasets: the deterministic flat (file, offset) index that defines
what an epoch and a batch are.

A numpy copy of `FlatSnippetIndex` and `SnippetDataset` from
`cpc_tpu/data/dataset.py` (importing `cpc_tpu.data` would pull in jax).
`SnippetDataset` walks the corpus directory in sorted order, counts each
file's snippets from its header (1 + (n - snippet) // stride), and builds a
flat index; item i is the i-th fixed-length snippet, float32, or int16 from
a per-file quantized cache for the int16 wire format. Both packages build
the same index over the same corpus (tests/test_torch_port_data.py).

WAV and FLAC (`data.wavio.decode_mono`), and any format added with
`register_decoder(ext, fn, info_fn=None)`, the JAX package's hook: the
corpus walk (`list_audio_files`) takes every registered extension. A
file's snippet count comes from its WAV header, FLAC STREAMINFO or the
format's `info_fn`, converted to the target rate as the resampler counts;
a file whose total is unknown (0), or without an `info_fn`, is decoded. A
file at another rate is resampled once, when it is decoded, on the
dataset's `device` (the CLIs pass their `--device`); one at the target rate
never touches it.

`ProbeDataset` adds the downstream probes' labels, as the JAX package's
does: the speaker from the directory layout, and per-sample phone labels
from a sibling `<utt>.phones.npy` (the synthetic corpus writes both),
remapped to the nearest native sample for a file at another rate.
"""

from __future__ import annotations

import bisect
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from cpc_tpu_torch.data.wavio import DECODERS, INFOS, decode, decode_mono


def register_decoder(ext: str, fn: Callable[[str], Tuple[np.ndarray, int]],
                     info_fn: Optional[Callable[[str], Tuple[int, int]]]
                     = None) -> None:
    """Adds (or replaces) the decoder of extension `ext`: fn(path) ->
    (samples (T, C) float32, native rate), and optionally info_fn(path) ->
    (num_samples, native rate) from the header alone."""
    DECODERS[ext.lower()] = fn
    if info_fn is not None:
        INFOS[ext.lower()] = info_fn


def list_audio_files(root: str,
                     exts: Optional[Sequence[str]] = None) -> List[str]:
    """The files under `root` with one of `exts` (default: every registered
    decoder's), in sorted walk order."""
    exts = tuple(e.lower() for e in (exts or DECODERS.keys()))
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if os.path.splitext(fn)[1].lower() in exts:
                out.append(os.path.join(dirpath, fn))
    return out


def _info(path: str) -> Tuple[int, int]:
    """(num_samples, native rate) from the header, or (0, 0) where the
    format has no probe or the header does not say."""
    probe = INFOS.get(os.path.splitext(path)[1].lower())
    try:
        return probe(path) if probe is not None else (0, 0)
    except (ValueError, OSError):
        return 0, 0


class _DecodedCache:
    """Small LRU of decoded mono float32 waveforms, and of their int16
    quantization (made once per file), with separate budgets."""

    def __init__(self, sample_rate: int, max_items: int = 256,
                 device="cuda"):
        self.sample_rate = sample_rate
        self.max_items = max_items
        self.device = device
        self._float: Dict[str, np.ndarray] = {}
        self._i16: Dict[str, np.ndarray] = {}

    def get(self, path: str) -> np.ndarray:
        x = self._float.pop(path, None)
        if x is None:
            x, _ = decode_mono(path, self.sample_rate, self.device)
        self._float[path] = x
        while len(self._float) > self.max_items:
            self._float.pop(next(iter(self._float)))
        return x

    def get_int16(self, path: str) -> np.ndarray:
        x = self._i16.pop(path, None)
        if x is None:
            f = self.get(path)
            x = np.clip(np.round(f * 32768.0), -32768, 32767).astype(np.int16)
        self._i16[path] = x
        while len(self._i16) > self.max_items:
            self._i16.pop(next(iter(self._i16)))
        return x


class FlatSnippetIndex:
    """The flat (file, offset) snippet-index arithmetic. Subclasses fill
    self.files / self._file_snippets, set snippet_samples and
    snippet_stride, and call _finalize_index()."""

    @staticmethod
    def snippet_count(n_samples: int, snippet_samples: int,
                      stride: int) -> int:
        return 0 if n_samples < snippet_samples else (
            1 + (n_samples - snippet_samples) // stride)

    def _finalize_index(self, where: str) -> None:
        if not self.files:
            raise ValueError(f"no usable audio under {where!r} "
                             f"(need >= {self.snippet_samples} samples "
                             f"per file)")
        self._cum = np.cumsum([0] + self._file_snippets)

    def __len__(self) -> int:
        return int(self._cum[-1])

    def _locate_file(self, idx: int) -> Tuple[int, int]:
        """index -> (file number, sample offset within the file)."""
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        f = bisect.bisect_right(self._cum, idx) - 1
        return f, (idx - int(self._cum[f])) * self.snippet_stride

    def locate(self, idx: int) -> Tuple[str, int]:
        """index -> (file path, sample offset)."""
        f, off = self._locate_file(idx)
        return self.files[f], off


class SnippetDataset(FlatSnippetIndex):
    """Flat snippet index over a corpus directory; files at another rate
    are resampled on `device`."""

    def __init__(
        self,
        corpus_dir: str,
        snippet_samples: int = 20_480,
        snippet_stride: Optional[int] = None,
        sample_rate: int = 16_000,
        cache_items: int = 256,
        device="cuda",
    ):
        self.corpus_dir = corpus_dir
        self.snippet_samples = snippet_samples
        self.snippet_stride = snippet_stride or snippet_samples
        self.sample_rate = sample_rate
        self._cache = _DecodedCache(sample_rate, cache_items, device)

        self.files: List[str] = []
        self._file_snippets: List[int] = []
        for path in list_audio_files(corpus_dir):
            cnt = self.snippet_count(self._num_samples(path),
                                     snippet_samples, self.snippet_stride)
            if cnt > 0:
                self.files.append(path)
                self._file_snippets.append(cnt)
        self._finalize_index(corpus_dir)

    def _num_samples(self, path: str) -> int:
        """Target-rate sample count, from the file's header when it gives
        one; else from a decode."""
        n, sr = _info(path)
        if n > 0:
            if sr == self.sample_rate:
                return n
            # ops.dsp.resample's output length
            g = int(np.gcd(sr, self.sample_rate))
            return (n * (self.sample_rate // g)) // (sr // g)
        return len(self._cache.get(path))

    def __getitem__(self, idx: int) -> np.ndarray:
        path, off = self.locate(idx)
        return self._cache.get(path)[off:off + self.snippet_samples]

    def snippet_int16(self, idx: int) -> np.ndarray:
        """Snippet in the int16 wire format (quantized once per file)."""
        path, off = self.locate(idx)
        return self._cache.get_int16(path)[off:off + self.snippet_samples]

    def speaker_of(self, idx: int) -> str:
        """Speaker id from the LibriSpeech-style path layout
        <root>/<speaker>/<chapter>/<utt> (used by the speaker probe)."""
        path, _ = self.locate(idx)
        rel = os.path.relpath(path, self.corpus_dir)
        return rel.split(os.sep)[0]


class ProbeDataset(SnippetDataset):
    """SnippetDataset that also yields labels for the downstream probes.

    Speaker labels come from the directory layout; phone labels from sibling
    `<utt>.phones.npy` per-sample label files when present. A label window
    that is short or missing gives None (the phone probe skips the snippet).
    The labels are per native sample: for a file at another rate, each
    target sample takes the label of the native sample at or before it, as
    `data.packed.pack_corpus` remaps them."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        speakers = sorted({self.speaker_of(int(self._cum[i]))
                           for i in range(len(self.files))})
        self.speaker_to_id = {s: i for i, s in enumerate(speakers)}
        self.num_speakers = len(speakers)
        self._rates: Dict[str, int] = {}

    def item_with_labels(self, idx: int):
        """(snippet float32 (S,), speaker id, phone labels (S,) or None)."""
        path, off = self.locate(idx)
        x = self._cache.get(path)[off:off + self.snippet_samples]
        spk = self.speaker_to_id[self.speaker_of(idx)]
        phones = None
        lab_path = os.path.splitext(path)[0] + ".phones.npy"
        if os.path.exists(lab_path):
            lab = np.load(lab_path)
            sr = self._native_rate(path)
            if sr == self.sample_rate:
                w = lab[off:off + self.snippet_samples]
                phones = w if len(w) == self.snippet_samples else None
            else:
                src = (np.arange(off, off + self.snippet_samples)
                       * sr) // self.sample_rate
                phones = lab[src] if src[-1] < len(lab) else None
        return x, spk, phones

    def _native_rate(self, path: str) -> int:
        if path not in self._rates:
            self._rates[path] = _info(path)[1] or decode(path)[1]
        return self._rates[path]
