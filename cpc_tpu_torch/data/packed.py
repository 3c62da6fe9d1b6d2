"""The packed corpus: decode once, train from a flat int16 memmap.

Port of `cpc_tpu/data/packed.py`, in its on-disk layout, so a corpus
packed by either package loads in the other. `python -m
cpc_tpu_torch.data.pack <corpus_dir> <packed_dir>` decodes every WAV and
FLAC file once (`data.wavio.decode_mono`: channels averaged, resampled to
the target rate on the device it is given), quantizes to int16 (the
host-to-device wire format) and writes:

    <packed_dir>/data.i16     all waveforms, concatenated int16 LE
    <packed_dir>/phones.u8    per-sample phone labels, aligned 1:1 with
                              data.i16; files without labels hold 255
    <packed_dir>/index.json   {"sample_rate", "total_samples", "has_phones",
                              "files": [{"path", "speaker", "offset",
                              "length"}, ...]}

Labels of a file at another rate are remapped to the nearest target
sample. `PackedSnippetDataset` is the `SnippetDataset` contract (the shared
`FlatSnippetIndex` arithmetic) over the memmap: reading a snippet decodes
nothing, and the page cache does the caching.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from cpc_tpu_torch.data.dataset import FlatSnippetIndex, list_audio_files
from cpc_tpu_torch.data.wavio import decode_mono

_NO_PHONE = 255


def pack_corpus(corpus_dir: str, out_dir: str, sample_rate: int = 16_000,
                device="cuda") -> dict:
    """Decodes, resamples (on `device`) and int16-quantizes every audio
    file under corpus_dir into <out_dir>/{data.i16, phones.u8,
    index.json}. Returns the index."""
    os.makedirs(out_dir, exist_ok=True)
    files = list_audio_files(corpus_dir)
    if not files:
        raise ValueError(f"no audio under {corpus_dir!r}")
    index: List[dict] = []
    offset = 0
    any_phones = False
    with open(os.path.join(out_dir, "data.i16"), "wb") as fd, \
            open(os.path.join(out_dir, "phones.u8"), "wb") as fp:
        for path in files:
            x, sr = decode_mono(path, sample_rate, device)
            pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
            fd.write(pcm.tobytes())

            lab_path = os.path.splitext(path)[0] + ".phones.npy"
            if os.path.exists(lab_path):
                lab = np.load(lab_path).astype(np.uint8)
                any_phones = True
                if sr != sample_rate:
                    # nearest-sample remap of per-sample labels
                    src = (np.arange(len(pcm)) * sr) // sample_rate
                    lab = lab[np.clip(src, 0, len(lab) - 1)]
                lab = lab[:len(pcm)]
                if len(lab) < len(pcm):
                    lab = np.pad(lab, (0, len(pcm) - len(lab)),
                                 constant_values=_NO_PHONE)
            else:
                lab = np.full(len(pcm), _NO_PHONE, np.uint8)
            fp.write(lab.tobytes())

            rel = os.path.relpath(path, corpus_dir)
            index.append({"path": rel,
                          "speaker": rel.split(os.sep)[0],
                          "offset": offset,
                          "length": int(len(pcm))})
            offset += len(pcm)
    meta = {"sample_rate": sample_rate, "total_samples": offset,
            "has_phones": any_phones, "files": index}
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump(meta, f)
    return meta


class PackedSnippetDataset(FlatSnippetIndex):
    """The SnippetDataset contract over a packed corpus, memmap-backed.

    Stands in for SnippetDataset and ProbeDataset in the Batcher, the
    Trainer and the probes (__len__, __getitem__, snippet_int16, locate,
    speaker_of, item_with_labels, num_speakers)."""

    def __init__(
        self,
        packed_dir: str,
        snippet_samples: int = 20_480,
        snippet_stride: Optional[int] = None,
        sample_rate: int = 16_000,
    ):
        with open(os.path.join(packed_dir, "index.json")) as f:
            meta = json.load(f)
        if meta["sample_rate"] != sample_rate:
            raise ValueError(
                f"packed corpus is {meta['sample_rate']} Hz; re-pack for "
                f"{sample_rate} Hz (resampling happens at pack time)")
        self.packed_dir = packed_dir
        self.snippet_samples = snippet_samples
        self.snippet_stride = snippet_stride or snippet_samples
        self.sample_rate = sample_rate
        self._data = np.memmap(os.path.join(packed_dir, "data.i16"),
                               dtype="<i2", mode="r")
        phones_path = os.path.join(packed_dir, "phones.u8")
        self._phones = (np.memmap(phones_path, dtype=np.uint8, mode="r")
                        if meta.get("has_phones") and
                        os.path.exists(phones_path) else None)

        self.files: List[str] = []
        self._file_offsets: List[int] = []
        self._file_snippets: List[int] = []
        self._speakers: List[str] = []
        for entry in meta["files"]:
            cnt = self.snippet_count(entry["length"], snippet_samples,
                                     self.snippet_stride)
            if cnt > 0:
                self.files.append(entry["path"])
                self._file_offsets.append(entry["offset"])
                self._file_snippets.append(cnt)
                self._speakers.append(entry["speaker"])
        self._finalize_index(packed_dir)
        uniq = sorted(set(self._speakers))
        self.speaker_to_id = {s: i for i, s in enumerate(uniq)}
        self.num_speakers = len(uniq)

    def _span(self, idx: int) -> Tuple[int, int]:
        f, off = self._locate_file(idx)
        return f, self._file_offsets[f] + off

    def snippet_int16(self, idx: int) -> np.ndarray:
        _, a = self._span(idx)
        return np.asarray(self._data[a:a + self.snippet_samples])

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.snippet_int16(idx).astype(np.float32) / 32768.0

    def speaker_of(self, idx: int) -> str:
        f, _ = self._span(idx)
        return self._speakers[f]

    def item_with_labels(self, idx: int):
        f, a = self._span(idx)
        x = self.__getitem__(idx)
        spk = self.speaker_to_id[self._speakers[f]]
        phones = None
        if self._phones is not None:
            lab = np.asarray(self._phones[a:a + self.snippet_samples])
            # snippets touching ANY unlabeled samples (the 255 sentinel —
            # files without alignments, or alignment tails shorter than the
            # audio) are excluded from the phone probe rather than leaking
            # the sentinel in as a fake 256th class
            if not (lab == _NO_PHONE).any():
                phones = lab.astype(np.int64)
        return x, spk, phones
