"""On-device scalogram front end: log-mel, log-spaced and constant-Q.

Port of `cpc_tpu/ops/scalogram.py` on `torch.fft`. The waveform goes to the
device raw and the whole chain runs there: reflect-padded framing (a view
through `Tensor.unfold`, no gather), a symmetric Hann window, the rFFT
(cuFFT on a CUDA tensor), |.|^2, one filterbank matmul and log compression;
`scale="cqt"` instead takes one matmul of the frames against a complex
constant-Q kernel bank. Everything runs in the input's dtype: the encoder
hands it fp32 whatever the model's dtype, and a float64 input gives the
reference the card is checked against.

The filterbanks and the constant-Q bank are designed in numpy, with the
JAX module's code copied here (that module imports jax.numpy), and go to a
device once: `_on_device` caches them per (design, device, dtype), so a
step uploads nothing and a module's state_dict holds none of them (an
exported graph holds them as its constants).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def _filterbank(n_fft: int, n_bins: int, fmin: float, fmax: float,
                sample_rate: int, scale: str) -> np.ndarray:
    """Triangular filterbank (n_freqs, n_bins); centers mel- or log-spaced
    (log spacing == constant-Q-like geometric center frequencies)."""
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    if scale == "mel":
        centers = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                         n_bins + 2))
    elif scale == "log":
        centers = np.geomspace(fmin, fmax, n_bins + 2)
    else:
        raise ValueError(f"unknown scalogram scale {scale!r}")
    fb = np.zeros((n_freqs, n_bins), dtype=np.float32)
    for b in range(n_bins):
        lo, mid, hi = centers[b], centers[b + 1], centers[b + 2]
        up = (freqs - lo) / max(mid - lo, 1e-9)
        down = (hi - freqs) / max(hi - mid, 1e-9)
        fb[:, b] = np.maximum(0.0, np.minimum(up, down))
    # Slaney-style area normalization keeps response ~flat across bins.
    enorm = 2.0 / (centers[2:] - centers[:-2])
    fb *= enorm[None, :].astype(np.float32)
    return fb


@functools.lru_cache(maxsize=8)
def _cqt_kernels(n_bins: int, fmin: float, fmax: float, sample_rate: int,
                 max_kernel: int):
    """Brown/Puckette-style constant-Q kernel bank. Returns (kernels
    (N_max, 2*n_bins) float32, N_max, Q, bins_per_octave): column 2k is bin
    k's real part, 2k+1 its imaginary.

    Per bin k: center f_k = fmin * 2^(k/b) with b bins/octave chosen so bin
    n_bins-1 lands on fmax; Q = 1/(2^(1/b)-1); kernel = Hann(N_k) *
    exp(-2pi i f_k n / sr) * 2/sum(w), N_k = Q*sr/f_k, zero-padded centered
    in N_max, which is rounded up to a multiple of 128. The 2/sum(w) scaling
    makes a unit-amplitude tone at f_k read ~1.0 in linear magnitude. Low
    bins needing N_k > max_kernel are truncated to max_kernel."""
    octaves = np.log2(fmax / fmin)
    b = (n_bins - 1) / octaves  # bins per octave
    Q = 1.0 / (2.0 ** (1.0 / b) - 1.0)
    f = fmin * 2.0 ** (np.arange(n_bins) / b)
    lens = np.minimum(np.round(Q * sample_rate / f).astype(int), max_kernel)
    n_max = int(lens.max())
    n_max = ((n_max + 127) // 128) * 128
    kern = np.zeros((n_max, 2 * n_bins), np.float32)
    for k in range(n_bins):
        N = int(lens[k])
        w = np.hanning(N)
        n = np.arange(N) - N / 2.0
        phase = -2.0 * np.pi * f[k] * n / sample_rate
        c = w * np.exp(1j * phase) * (2.0 / w.sum())
        s = (n_max - N) // 2  # center every kernel in the frame
        kern[s:s + N, 2 * k] = c.real.astype(np.float32)
        kern[s:s + N, 2 * k + 1] = c.imag.astype(np.float32)
    return kern, n_max, float(Q), float(b)


def _design(design: str, args: tuple) -> np.ndarray:
    """The numpy constant `design(*args)`."""
    if design == "hann":
        return np.hanning(*args).astype(np.float32)  # symmetric, as JAX's
    if design == "filterbank":
        return _filterbank(*args)
    return _cqt_kernels(*args)[0]


@functools.lru_cache(maxsize=16)
def _on_device(design: str, args: tuple, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """The numpy constant `design(*args)` as a tensor on `device`, made once.
    Made outside inference mode, so that a bank first made during
    extraction still serves a training step."""
    with torch.inference_mode(False):
        return torch.from_numpy(_design(design, args)).to(device, dtype)


def _bank(design: str, args: tuple, device: torch.device,
          dtype: torch.dtype) -> torch.Tensor:
    """`_on_device`, but in a graph being exported (`export.py`), where the
    tensor made is the tracer's and must not be cached for live calls: there
    the bank is made anew, a constant of the graph."""
    if torch.compiler.is_exporting():
        return torch.from_numpy(_design(design, args)).to(device, dtype)
    return _on_device(design, args, device, dtype)


def cqt(
    x: torch.Tensor,
    *,
    hop: int = 160,
    n_bins: int = 128,
    fmin: float = 32.7,
    fmax: float = 8000.0,
    sample_rate: int = 16_000,
    max_kernel: int = 16_384,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Constant-Q transform: waveform (B, T) -> log-power (B, T//hop, n_bins)
    with per-bin Q, as ONE matmul of the overlapping frames against the
    complex kernel bank."""
    _, n_max, _, _ = _cqt_kernels(n_bins, fmin, fmax, sample_rate,
                                  max_kernel)
    if x.shape[-1] <= n_max // 2:
        raise ValueError(
            f"cqt needs waveforms longer than half its longest analysis "
            f"window ({n_max // 2} samples = {n_max / 2 / sample_rate:.2f} s "
            f"at fmin={fmin}); got {x.shape[-1]} samples — raise fmin, "
            f"lower max_kernel, or feed longer audio")
    kern = _bank("cqt", (n_bins, fmin, fmax, sample_rate, max_kernel),
                 x.device, x.dtype)
    proj = frame_signal(x, n_max, hop) @ kern  # (B, T', 2*n_bins)
    re = proj[..., 0::2]
    im = proj[..., 1::2]
    return torch.log(re * re + im * im + eps)


def cqt_design(n_bins: int, fmin: float, fmax: float, sample_rate: int,
               max_kernel: int = 16_384):
    """(center_freqs, kernel_lengths, Q, bins_per_octave) of the bank that
    cqt() uses."""
    _, _, Q, b = _cqt_kernels(n_bins, fmin, fmax, sample_rate, max_kernel)
    f = fmin * 2.0 ** (np.arange(n_bins) / b)
    lens = np.minimum(np.round(Q * sample_rate / f).astype(int), max_kernel)
    return f, lens, Q, b


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, T // hop, frame_len), frame i centred at sample i * hop
    of the signal reflect-padded by frame_len // 2 on each side: a strided
    view of the padded signal. torch's reflect padding needs T > frame_len
    // 2."""
    B, T = x.shape
    pad = frame_len // 2
    xp = F.pad(x, (pad, pad), mode="reflect")
    return xp.unfold(-1, frame_len, hop)[:, :T // hop]


def scalogram(
    x: torch.Tensor,
    *,
    n_fft: int = 1024,
    hop: int = 160,
    n_bins: int = 128,
    fmin: float = 32.7,
    fmax: float = 8000.0,
    scale: str = "mel",
    sample_rate: int = 16_000,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Waveform (B, T) -> log-power scalogram (B, T//hop, n_bins), on x's
    device and in x's dtype.

    scale='mel'|'log' use a fixed n_fft STFT + triangular filterbank;
    scale='cqt' dispatches to the constant-Q bank (per-bin windows)."""
    if scale == "cqt":
        return cqt(x, hop=hop, n_bins=n_bins, fmin=fmin, fmax=fmax,
                   sample_rate=sample_rate, eps=eps)
    fb = _bank("filterbank", (n_fft, n_bins, fmin, fmax, sample_rate,
                              scale), x.device, x.dtype)
    window = _bank("hann", (n_fft,), x.device, x.dtype)
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop) * window, dim=-1)
    power = spec.abs() ** 2  # (B, frames, n_freqs)
    return torch.log(power @ fb + eps)
