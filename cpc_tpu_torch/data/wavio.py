"""WAV read and write in numpy, and the one definition of "load a file".

A copy of `cpc_tpu/data/wavio.py` (`read_wav`, `wav_info`, `write_wav`) and
of `cpc_tpu/data/dataset.py::decode` and `decode_mono`: the port cannot
import `cpc_tpu.data` without jax. RIFF/WAVE, PCM 8/16/24/32-bit and IEEE
float 32/64, and FLAC through `data.flac`; any channel count (averaged to
mono by `decode_mono`). A file at another rate than the target is
resampled once, at decode, by `ops.dsp.resample` on the device the caller
names, as the JAX package resamples on its default device.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np
import torch

from cpc_tpu_torch.data.flac import flac_info, read_flac
from cpc_tpu_torch.ops.dsp import resample


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (samples (T, C) float32 in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = b""
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = _extensible_subformat(path, fmt_body)
    if audio_format == 1:  # PCM
        if bits == 8:
            x = (_raw_arr(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = _raw_arr(raw, np.int16).astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = _raw_arr(raw, np.int32).astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = _raw_arr(raw, np.float32 if bits == 32 else np.float64).astype(
            np.float32)
    else:
        raise ValueError(f"{path}: unsupported audio format {audio_format}")
    if n_channels > 1:
        x = x[: (len(x) // n_channels) * n_channels].reshape(-1, n_channels)
    else:
        x = x.reshape(-1, 1)
    return x, sample_rate


def wav_info(path: str) -> Tuple[int, int]:
    """(num_frames, sample_rate) from the RIFF header alone, without
    decoding a sample: the dataset's snippet count reads it."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[0:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        n_channels = bits = None
        data_size = None
        sample_rate = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid = hdr[0:4]
            size = struct.unpack_from("<I", hdr, 4)[0]
            if cid == b"fmt ":
                body = f.read(size)
                _, n_channels, sample_rate, _, _, bits = struct.unpack_from(
                    "<HHIIHH", body, 0)
            elif cid == b"data":
                data_size = size
                f.seek(size + (size & 1), 1)
            else:
                f.seek(size + (size & 1), 1)
            if cid == b"fmt " and size & 1:
                f.seek(1, 1)
    if n_channels is None or data_size is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    bytes_per_frame = n_channels * max(1, bits // 8)
    return data_size // bytes_per_frame, sample_rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Writes mono/multichannel float32 [-1, 1] as PCM16."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    n_channels = pcm.shape[1]
    byte_rate = sample_rate * n_channels * 2
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, n_channels, sample_rate,
                            byte_rate, n_channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def _extensible_subformat(path: str, fmt_body: bytes) -> int:
    """WAVE_FORMAT_EXTENSIBLE: the real codec is the first two bytes of the
    SubFormat GUID at offset 24 of the fmt chunk (1=PCM, 3=IEEE float)."""
    if len(fmt_body) < 26:
        raise ValueError(f"{path}: extensible fmt chunk too short "
                         f"({len(fmt_body)} bytes) for a SubFormat GUID")
    sub = struct.unpack_from("<H", fmt_body, 24)[0]
    if sub not in (1, 3):
        raise ValueError(f"{path}: unsupported extensible SubFormat {sub}")
    return sub


def _raw_arr(raw: bytes, dtype) -> np.ndarray:
    item = np.dtype(dtype).itemsize
    return np.frombuffer(raw[: (len(raw) // item) * item], dtype=dtype)


DECODERS = {".wav": read_wav, ".flac": read_flac}
# header-only (num_samples, native_rate) probes: no sample is decoded
INFOS = {".wav": wav_info, ".flac": flac_info}


def decode(path: str) -> Tuple[np.ndarray, int]:
    """(samples (T, C) float32 in [-1, 1], native rate) of a WAV or FLAC
    file."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in DECODERS:
        raise ValueError(f"no decoder for {ext!r} ({path}); "
                         f"have {sorted(DECODERS)}")
    return DECODERS[ext](path)


def decode_mono(path: str, target_rate: int, device="cuda"
                ) -> Tuple[np.ndarray, int]:
    """(float32 mono waveform at target_rate, native rate). The channels
    are averaged first; a file at another rate is then resampled on
    `device`, which is touched only then."""
    audio, sr = decode(path)
    x = audio.mean(axis=1) if audio.shape[1] > 1 else audio[:, 0]
    x = np.ascontiguousarray(x, dtype=np.float32)
    if sr != target_rate:
        t = torch.from_numpy(x[None]).to(device)
        x = resample(t, sr, target_rate)[0].cpu().numpy()
    return x, sr
