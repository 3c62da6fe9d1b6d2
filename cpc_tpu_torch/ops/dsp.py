"""Waveform DSP on the device: dequantization, normalization, resampling
and augmentation.

Port of `cpc_tpu/ops/dsp.py`. The host ships int16 (half the bytes of
fp32) and the device dequantizes and normalizes (`prepare_waveform`), as
in the JAX package.

`resample` is the JAX package's rational windowed-sinc resampler, with the
same phase table (`_resample_kernel`: the same float64 arithmetic, cast to
float32 once, so both packages hold the same table bit for bit). The JAX
version gathers every output's window at once, (B, out_len, taps): at
44.1 -> 16 kHz (97 taps) an hour of audio is 22 GB. Here the outputs are
taken a period at a time (`up` outputs read the input `down` samples
further on), as strided views of the padded input, and the taps are summed
one at a time into an fp32 accumulator, in chunks of outputs of at most
`RESAMPLE_CHUNK_BYTES`. Every output is the same sum in the same order
whatever the chunk, so the result does not depend on the chunk size.

`augment_waveform` is the JAX package's on-device augmentation, in its
order: gain, polarity, circular shift, then white noise at a random SNR
scaled by the shifted signal's power. Its draws come from an explicit
`torch.Generator` on the waveform's device (`augment_draws`), so they
cannot equal `jax.random`'s; `apply_augment` applies given draws.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

RESAMPLE_CHUNK_BYTES = 32 << 20


def dequantize(x: torch.Tensor) -> torch.Tensor:
    """int16 wire format -> float32 in [-1, 1]. No-op for float input."""
    if x.dtype == torch.int16:
        return x.to(torch.float32) / 32768.0
    return x.to(torch.float32)


def normalize_snippets(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-snippet mean/variance normalization over the time axis.

    The variance is the population variance (`jnp.var`), hence
    `correction=0`; eps sits inside the square root."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps)


def prepare_waveform(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    x = dequantize(x)
    if normalize:
        x = normalize_snippets(x)
    return x


class AugmentDraws(NamedTuple):
    """One batch's augmentation draws; None for a factor that is off."""
    gain: torch.Tensor               # (B, 1) linear gain
    sign: Optional[torch.Tensor]     # (B, 1) +1 or -1
    shift: Optional[torch.Tensor]    # (B,) int64 in [-shift_max, shift_max]
    snr: Optional[torch.Tensor]      # (B, 1) linear SNR
    noise: Optional[torch.Tensor]    # (B, S) standard normal


def augment_draws(shape, generator: torch.Generator, *, gain_db: float = 6.0,
                  noise_snr_db: float = 30.0, shift_max: int = 160,
                  polarity: bool = True) -> AugmentDraws:
    """The draws of a (B, S) batch, from `generator` on its device: gain
    uniform in +-gain_db dB, polarity +-1 with probability 1/2 each, a shift
    uniform in [-shift_max, shift_max] (off at 0), an SNR uniform in
    [noise_snr_db, noise_snr_db + 20] dB with its standard normal noise
    (off at noise_snr_db >= 100)."""
    B, S = shape
    kw = dict(generator=generator, device=generator.device)

    def uniform(lo, hi):
        return lo + torch.rand((B, 1), **kw) * (hi - lo)
    gain = 10.0 ** (uniform(-gain_db, gain_db) / 20.0)
    sign = (torch.where(torch.rand((B, 1), **kw) < 0.5, 1.0, -1.0)
            if polarity else None)
    shift = (torch.randint(-shift_max, shift_max + 1, (B,), **kw)
             if shift_max > 0 else None)
    snr = noise = None
    if noise_snr_db < 100.0:
        snr = 10.0 ** (uniform(noise_snr_db, noise_snr_db + 20.0) / 10.0)
        noise = torch.randn((B, S), **kw)
    return AugmentDraws(gain, sign, shift, snr, noise)


def apply_augment(x: torch.Tensor, d: AugmentDraws) -> torch.Tensor:
    """x (B, S) float32 augmented by the draws `d`, in the JAX order."""
    x = x * d.gain
    if d.sign is not None:
        x = x * d.sign
    if d.shift is not None:
        S = x.shape[1]
        idx = (torch.arange(S, device=x.device)[None, :]
               + d.shift[:, None]) % S
        x = torch.take_along_dim(x, idx, dim=1)
    if d.noise is not None:
        sig_pow = torch.mean(x * x, dim=1, keepdim=True)
        x = x + d.noise * torch.sqrt(sig_pow / d.snr)
    return x


def augment_waveform(x: torch.Tensor, generator: torch.Generator, *,
                     gain_db: float = 6.0, noise_snr_db: float = 30.0,
                     shift_max: int = 160, polarity: bool = True
                     ) -> torch.Tensor:
    """Per-snippet random gain, polarity flip, circular shift (up to one
    latent stride at the default) and white noise, on x's device; all
    randomness from `generator`. x: (B, S) float32."""
    return apply_augment(x, augment_draws(
        x.shape, generator, gain_db=gain_db, noise_snr_db=noise_snr_db,
        shift_max=shift_max, polarity=polarity))


@functools.lru_cache(maxsize=8)
def _resample_kernel(sr_in: int, sr_out: int, width: int = 16):
    """Per-phase windowed-sinc interpolation kernels for rational resampling.

    Output sample m sits at input position m*down/up = n0 + p/up; the
    phase-p kernel is the Hann-windowed, cutoff-scaled sinc at the offsets
    (q - half) - p/up for q in [0, taps). Returns (h (up, taps) float32, up,
    down)."""
    g = np.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    half = width * max(1, -(-down // up))  # half-width in input samples
    taps = 2 * half + 1
    cutoff = min(1.0, up / down)
    q = np.arange(taps) - half
    t = q[None, :] - (np.arange(up) / up)[:, None]  # (up, taps)
    win = np.where(np.abs(t) <= half,
                   0.5 * (1.0 + np.cos(np.pi * t / half)), 0.0)
    h = cutoff * np.sinc(cutoff * t) * win
    return h.astype(np.float32), up, down


def resample(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """Rational-ratio windowed-sinc resampling on x's device: (B, T) ->
    (B, T * up // down) float32, as `cpc_tpu.ops.dsp.resample`.

    Output m = j * up + r reads the padded input from j * down + off[r]
    on, with phase p[r]: out[m] = sum_q xp[j * down + off[r] + q] * h[p[r],
    q]. A chunk of periods j is one strided view (B, J, span) of xp; each
    tap q adds one column gather of it, weighted by h[p, q]."""
    if sr_in == sr_out:
        return x
    h, up, down = _resample_kernel(sr_in, sr_out)
    taps = h.shape[1]
    half = taps // 2
    B, T = x.shape
    out_len = (T * up) // down
    r = np.arange(up)
    off, phase = (r * down) // up, (r * down) % up
    span = int(off[-1]) + taps  # the input one period of outputs reads
    periods = -(-out_len // up)
    # zeros past JAX's (half, half) padding: only outputs past out_len
    # (the last period's tail, cut below) read them
    right = max(half, (periods - 1) * down + span - half - T)
    xp = torch.nn.functional.pad(x.to(torch.float32), (half, right))
    dev = x.device
    hq = torch.from_numpy(np.ascontiguousarray(h[phase].T)).to(dev)
    cols = torch.from_numpy(off[None, :] + np.arange(taps)[:, None]).to(dev)
    per_chunk = max(1, RESAMPLE_CHUNK_BYTES // (4 * B * up))
    out = torch.empty((B, periods * up), dtype=torch.float32, device=dev)
    for j0 in range(0, periods, per_chunk):
        n = min(per_chunk, periods - j0)
        win = xp.as_strided((B, n, span), (xp.stride(0), down, 1),
                            j0 * down)
        acc = torch.zeros((B, n, up), dtype=torch.float32, device=dev)
        for q in range(taps):
            acc.addcmul_(win.index_select(2, cols[q]), hq[q])
        out[:, j0 * up:(j0 + n) * up] = acc.reshape(B, n * up)
    return out[:, :out_len]
