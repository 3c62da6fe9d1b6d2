"""FLAC reading: STREAMINFO in Python, samples through the native decoder.

Port of `cpc_tpu/data/flac.py`. `flac_info` reads (total samples, rate)
from the STREAMINFO block without decoding. `read_flac` decodes through
`data/native/flacdec.cpp` (the port's copy of the JAX package's decoder),
bound with ctypes.

The library is built with `g++ -O2 -fPIC -shared -std=c++17` at first use,
under `build/flac/` at the root of the checkout, keyed by a hash of the
source and the flags, as `ops/_build.py` keys the kernels: an unchanged
source reuses its library. g++ writes to a name of its own process and
thread, and the result is renamed into place, so processes and threads
that build at the same moment never load a half-written file. A failed
build raises with g++'s messages. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "flacdec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flac"
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"flacdec-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the decoder unless its library exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the FLAC decoder failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.flac_decode_file.restype = ctypes.c_int
    lib.flac_decode_file.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.flac_free.restype = None
    lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    return lib


def flac_info(path: str) -> Tuple[int, int]:
    """(total_samples, sample_rate) from the STREAMINFO block, without
    decoding a sample. total_samples is 0 when the encoder left it unknown;
    callers then decode."""
    with open(path, "rb") as f:
        if f.read(4) != b"fLaC":
            raise ValueError(f"{path}: not a FLAC file")
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                raise ValueError(f"{path}: no STREAMINFO block")
            last = hdr[0] & 0x80
            btype = hdr[0] & 0x7F
            length = (hdr[1] << 16) | (hdr[2] << 8) | hdr[3]
            if btype == 0:  # STREAMINFO
                b = f.read(length)
                if len(b) < 18:
                    raise ValueError(f"{path}: truncated STREAMINFO")
                sr = (b[10] << 12) | (b[11] << 4) | (b[12] >> 4)
                total = ((b[13] & 0x0F) << 32) | (b[14] << 24) | \
                    (b[15] << 16) | (b[16] << 8) | b[17]
                return total, sr
            f.seek(length, 1)
            if last:
                raise ValueError(f"{path}: no STREAMINFO block")


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """(samples (T, C) float32 in [-1, 1], sample_rate): the contract of
    `data.wavio.read_wav`."""
    lib = load_library()
    out = ctypes.POINTER(ctypes.c_int32)()
    n = ctypes.c_int64()
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    bps = ctypes.c_int32()
    rc = lib.flac_decode_file(os.fsencode(path), ctypes.byref(out),
                              ctypes.byref(n), ctypes.byref(ch),
                              ctypes.byref(sr), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f"{path}: FLAC decode failed (code {rc})")
    try:
        count = n.value * ch.value
        arr = np.ctypeslib.as_array(out, shape=(count,)).copy()
    finally:
        lib.flac_free(out)
    x = arr.astype(np.float32) / float(1 << (bps.value - 1))
    return x.reshape(n.value, ch.value), sr.value
