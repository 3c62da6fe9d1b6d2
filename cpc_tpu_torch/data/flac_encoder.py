"""A small FLAC encoder in numpy and the standard library.

A copy of `cpc_tpu/data/flac_encoder.py`: the port cannot import
`cpc_tpu.data` without jax. It writes the whole branch set of the native
decoder (`data/native/flacdec.cpp`): CONSTANT / VERBATIM / FIXED(0-4) /
LPC(1-32, Levinson-Durbin, quantized) subframes; RICE and RICE2 residuals
with partition orders and escape codes; wasted bits; independent /
left-side / right-side / mid-side stereo; 8/12/16/20/24-bit PCM. The tests
and `chip_smoke.py` write their FLAC corpora with it; training reads FLAC
through the decoder only. It writes bit by bit in Python: about a second
of work for a second of 44.1 kHz stereo.
"""

from __future__ import annotations

import struct

import numpy as np


class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.cur = 0
        self.nbits = 0

    def write(self, value: int, bits: int):
        value &= (1 << bits) - 1
        for i in range(bits - 1, -1, -1):
            self.cur = (self.cur << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.bytes.append(self.cur)
                self.cur = 0
                self.nbits = 0

    def write_unary(self, q: int):
        for _ in range(q):
            self.write(0, 1)
        self.write(1, 1)

    def align(self):
        while self.nbits:
            self.write(0, 1)

    def data(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.bytes)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _utf8_code(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    if n < 0x800:
        return bytes([0xC0 | (n >> 6), 0x80 | (n & 0x3F)])
    if n < 0x10000:
        return bytes([0xE0 | (n >> 12), 0x80 | ((n >> 6) & 0x3F),
                      0x80 | (n & 0x3F)])
    raise ValueError("frame index too large for this encoder")


_SR_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
             24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
_BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


def _zigzag(r: np.ndarray) -> np.ndarray:
    return np.where(r >= 0, r.astype(np.int64) << 1,
                    ((-r.astype(np.int64)) << 1) - 1)


_FIXED_DIFF = {
    0: lambda x: x,
    1: lambda x: x[1:] - x[:-1],
    2: lambda x: x[2:] - 2 * x[1:-1] + x[:-2],
    3: lambda x: x[3:] - 3 * x[2:-1] + 3 * x[1:-2] - x[:-3],
    4: lambda x: x[4:] - 4 * x[3:-1] + 6 * x[2:-2] - 4 * x[1:-3] + x[:-4],
}


def _rice_param(zz: np.ndarray, cap: int) -> int:
    mean = max(float(zz.mean()), 0.1) if len(zz) else 0.1
    return min(cap, max(0, int(np.ceil(np.log2(mean + 1)))))


def _write_residual(bw: _BitWriter, res: np.ndarray, blocksize: int,
                    order: int, *, method: str = "rice",
                    partition_order: int = 0, escape_parts: bool = False):
    """FLAC residual: method (RICE 4-bit / RICE2 5-bit params), 2^porder
    partitions with per-partition parameters; escape_parts writes every odd
    partition as raw fixed-width samples (the escape-code decoder branch)."""
    method_bit = {"rice": 0, "rice2": 1}[method]
    plen = 4 if method == "rice" else 5
    esc = (1 << plen) - 1
    cap = esc - 1
    # lower the order until it fits this block (real encoders do the same
    # for the final partial block: partitions must divide the blocksize and
    # the first partition must be non-empty after the warmup samples)
    while partition_order > 0 and (
            blocksize % (1 << partition_order)
            or (blocksize >> partition_order) <= order):
        partition_order -= 1
    nparts = 1 << partition_order
    bw.write(method_bit, 2)
    bw.write(partition_order, 4)
    idx = 0
    for p in range(nparts):
        count = (blocksize >> partition_order) - (order if p == 0 else 0)
        part = res[idx:idx + count]
        idx += count
        if escape_parts and p % 2 == 1:
            bits = max(2, int(np.max(np.abs(part))).bit_length() + 1) \
                if len(part) else 2
            bits = min(bits, 31)
            bw.write(esc, plen)
            bw.write(bits, 5)
            for v in part:
                bw.write(int(v), bits)
        else:
            zz = _zigzag(part)
            param = _rice_param(zz, cap)
            bw.write(param, plen)
            for v in zz:
                bw.write_unary(int(v) >> param)
                bw.write(int(v), param)


def _lpc_quantized(x: np.ndarray, order: int, precision: int = 12):
    """Levinson-Durbin LPC coefficients, quantized to `precision` bits with
    a shift — the same (coef, shift) contract libFLAC writes.
    Returns (qcoef int64 (order,), shift int)."""
    xf = x.astype(np.float64)
    # Welch-windowed autocorrelation keeps the normal equations well-posed
    n = len(xf)
    w = 1.0 - (2.0 * np.arange(n) / max(n - 1, 1) - 1.0) ** 2
    xw = xf * w
    autoc = np.array([np.dot(xw[: n - lag], xw[lag:])
                      for lag in range(order + 1)])
    if autoc[0] <= 0:
        return np.zeros(order, np.int64), 0
    err = autoc[0]
    a = np.zeros(order)
    for i in range(order):
        acc = autoc[i + 1] - np.dot(a[:i], autoc[i:0:-1])
        k = acc / err
        a[:i] = a[:i] - k * a[:i][::-1]
        a[i] = k
        err *= (1.0 - k * k)
        if err <= 0:
            break
    cmax = np.max(np.abs(a))
    if cmax <= 0:
        return np.zeros(order, np.int64), 0
    # largest shift (<= 15, 5-bit non-negative) keeping coefs in precision
    shift = min(15, max(0, precision - 2 - int(np.floor(np.log2(cmax)))))
    lim = 1 << (precision - 1)
    qcoef = np.clip(np.round(a * (1 << shift)), -lim, lim - 1).astype(np.int64)
    return qcoef, shift


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int, mode: str,
                     *, residual_method: str = "rice",
                     partition_order: int = 0, escape_parts: bool = False,
                     use_wasted: bool = False, lpc_precision: int = 12):
    x = x.astype(np.int64)
    blocksize = len(x)
    if mode == "auto":
        if np.all(x == x[0]):
            mode = "constant"
        else:
            mode = "fixed2" if blocksize > 4 else "verbatim"
    if (mode.startswith("fixed") or mode.startswith("lpc")) \
            and int(mode.lstrip("fixedlpc") or 0) >= blocksize:
        mode = "verbatim"  # tail block shorter than the predictor order
    bw.write(0, 1)  # reserved

    wasted = 0
    if use_wasted and mode != "constant" and np.any(x != 0):
        nz = x[x != 0]
        wasted = int(min(int(v & -v).bit_length() - 1 for v in nz))
        wasted = min(wasted, bps - 2)

    def write_wasted():
        if wasted > 0:
            bw.write(1, 1)
            bw.write_unary(wasted - 1)
        else:
            bw.write(0, 1)

    if wasted:
        x = x >> wasted
        bps -= wasted

    if mode == "constant":
        bw.write(0, 6)
        write_wasted()
        bw.write(int(x[0]), bps)
    elif mode == "verbatim":
        bw.write(1, 6)
        write_wasted()
        for v in x:
            bw.write(int(v), bps)
    elif mode.startswith("fixed"):
        order = int(mode[5:])
        if order not in _FIXED_DIFF:
            raise ValueError(f"unknown subframe mode {mode!r}")
        bw.write(8 + order, 6)
        write_wasted()
        for v in x[:order]:
            bw.write(int(v), bps)
        res = _FIXED_DIFF[order](x)
        _write_residual(bw, res, blocksize, order, method=residual_method,
                        partition_order=partition_order,
                        escape_parts=escape_parts)
    elif mode.startswith("lpc"):
        order = int(mode[3:])
        if not 1 <= order <= 32 or order >= blocksize:
            raise ValueError(f"bad LPC order in {mode!r}")
        qcoef, shift = _lpc_quantized(x, order, lpc_precision)
        bw.write(32 + order - 1, 6)
        write_wasted()
        for v in x[:order]:
            bw.write(int(v), bps)
        bw.write(lpc_precision - 1, 4)
        bw.write(shift, 5)
        for cfc in qcoef:
            bw.write(int(cfc), lpc_precision)
        # residual vs the integer predictor the decoder will run
        idx = np.arange(order, blocksize)
        pred = np.zeros(blocksize - order, np.int64)
        for j in range(order):
            pred += qcoef[j] * x[idx - 1 - j]
        res = x[order:] - (pred >> shift)
        _write_residual(bw, res, blocksize, order, method=residual_method,
                        partition_order=partition_order,
                        escape_parts=escape_parts)
    else:
        raise ValueError(f"unknown subframe mode {mode!r}")


def write_flac(
    path: str,
    samples: np.ndarray,
    sample_rate: int,
    *,
    bits_per_sample: int = 16,
    block_size: int = 4096,
    subframe: str = "auto",     # 'auto'|'constant'|'verbatim'|'fixedN'|'lpcN'
    stereo_mode: str = "independent",  # |'mid_side'|'left_side'|'right_side'
    residual_method: str = "rice",     # 'rice' | 'rice2'
    partition_order: int = 0,          # 2^n residual partitions per subframe
    escape_partitions: bool = False,   # raw-bits escape on odd partitions
    wasted_bits: bool = False,         # detect+signal trailing-zero bits
    lpc_precision: int = 12,
):
    """samples: float32 (T,) or (T, C) in [-1, 1], or integer PCM."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    if np.issubdtype(x.dtype, np.floating):
        scale = (1 << (bits_per_sample - 1)) - 1
        x = np.clip(np.round(x * scale), -scale - 1, scale).astype(np.int64)
    T, C = x.shape
    if C > 2 and stereo_mode != "independent":
        raise ValueError("stereo modes need exactly 2 channels")
    if sample_rate not in _SR_CODES:
        raise ValueError(f"unsupported sample rate {sample_rate}")
    if bits_per_sample not in _BPS_CODES:
        raise ValueError(f"unsupported bit depth {bits_per_sample}")

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(C - 1, 3)
    si.write(bits_per_sample - 1, 5)
    si.write(T, 36)
    body = si.data() + b"\x00" * 16  # MD5 unset (decoders don't require it)
    out += bytes([0x80]) + struct.pack(">I", len(body))[1:] + body

    n_frames = (T + block_size - 1) // block_size
    for fi in range(n_frames):
        blk = x[fi * block_size:(fi + 1) * block_size]
        bs = len(blk)
        hdr = _BitWriter()
        hdr.write(0x3FFE, 14)
        hdr.write(0, 1)  # reserved
        hdr.write(0, 1)  # fixed blocksize stream
        if bs == block_size and block_size in (256, 512, 1024, 2048, 4096,
                                               8192, 16384, 32768):
            bs_code = {256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
                       8192: 13, 16384: 14, 32768: 15}[block_size]
            custom_bs = None
        else:
            bs_code, custom_bs = 7, bs - 1
        hdr.write(bs_code, 4)
        hdr.write(_SR_CODES[sample_rate], 4)
        if C == 2 and stereo_mode == "mid_side":
            hdr.write(10, 4)
        elif C == 2 and stereo_mode == "left_side":
            hdr.write(8, 4)
        elif C == 2 and stereo_mode == "right_side":
            hdr.write(9, 4)
        else:
            hdr.write(C - 1, 4)
        hdr.write(_BPS_CODES[bits_per_sample], 3)
        hdr.write(0, 1)
        hdr.align()
        hbytes = bytearray(hdr.data())
        hbytes += _utf8_code(fi)
        if custom_bs is not None:
            hbytes += struct.pack(">H", custom_bs)
        hbytes.append(_crc8(bytes(hbytes)))

        fb = _BitWriter()
        enc = lambda x, bps: _encode_subframe(
            fb, x, bps, subframe, residual_method=residual_method,
            partition_order=partition_order,
            escape_parts=escape_partitions, use_wasted=wasted_bits,
            lpc_precision=lpc_precision)
        if C == 2 and stereo_mode == "mid_side":
            l, r = blk[:, 0], blk[:, 1]
            enc((l + r) >> 1, bits_per_sample)
            enc(l - r, bits_per_sample + 1)
        elif C == 2 and stereo_mode == "left_side":
            l, r = blk[:, 0], blk[:, 1]
            enc(l, bits_per_sample)
            enc(l - r, bits_per_sample + 1)
        elif C == 2 and stereo_mode == "right_side":
            l, r = blk[:, 0], blk[:, 1]
            enc(l - r, bits_per_sample + 1)
            enc(r, bits_per_sample)
        else:
            for c in range(C):
                enc(blk[:, c], bits_per_sample)
        fb.align()
        frame = bytes(hbytes) + fb.data()
        frame += struct.pack(">H", _crc16(frame))
        out += frame

    with open(path, "wb") as f:
        f.write(bytes(out))
