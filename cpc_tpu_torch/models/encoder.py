"""genc: the strided Conv1d encoder over the raw waveform, and the Conv2d
encoder over an on-device scalogram for music audio.

`ConvEncoder` ports `cpc_tpu/models/encoder.py::ConvEncoder` (conv1d kind):
5 Conv1d layers, channels 512, kernels (10, 8, 4, 4, 4), strides (5, 4, 2,
2, 2), 160x downsampling, ReLU. The public layout is the JAX package's
(B, T, C); inside, the convs run on (B, C, T) as `F.conv1d` expects.

SAME padding is flax's, which `Conv1d(padding='same')` cannot give for a
stride above 1: for t_out = ceil(t_in / s) the total padding is
max((t_out - 1) * s + k - t_in, 0), split (total // 2, rest). It gives
exactly T // 160 latents (20480 -> 128); VALID gives 126.

Taken from the JAX encoder: padding SAME | VALID; norm none | layer (flax
LayerNorm, eps 1e-6) | group (flax GroupNorm: min(32, ch) groups, statistics
over time and the group's channels, eps 1e-6) | batch (`_BatchStatsNorm`:
the live batch's statistics over (B, T) in fp32, eps 1e-5, no running
averages, so training and eval compute the same); activation relu | gelu
(tanh form, as flax) | tanh; `remat`, which recomputes each (conv, norm,
activation) block in the backward through `torch.utils.checkpoint`; and
`use_pallas`, which sends the whole pyramid to the hand-written CUDA
kernels of `ops/conv_cuda.py` (SAME padding, no norm, relu only; the
parameters are the same on both routes).

Under context parallelism (`parallel/cp.py`) the waveform's time axis is
sharded over the ranks of a ring, and `_cp_forward` runs the same layers
on this rank's shard: `_cp_layer` first swaps each layer's SAME-padding
halo with the ring's neighbours (flax's (total // 2, rest) split of
max(k - s, 0) samples, the left part from the rank before, the right part
from the rank after; zeros at rank 0's left and rank R-1's right), then
convolves without padding. The halo's gradient goes back to the rank it
came from (`ops.ring_util.ppermute`), and a remat recompute swaps it
again. A group or batch norm takes its statistics over the whole time
axis (a sum over the ring); a layer norm is per position. SAME padding and
the plain route only, as in the JAX package.

`ScalogramEncoder` ports the JAX `ScalogramEncoder`: the log-power
scalogram of `ops/scalogram.py` in fp32, then a Conv2d stack over (time,
freq) with flax's SAME padding on each axis, the same norms and
activations, and `proj` from the folded (freq', channel) axis to d_enc.
`make_encoder` picks the encoder by `config.kind`, and `encoder_width` is
the width of its z, the gar's input.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cpc_tpu_torch.config import EncoderConfig
from cpc_tpu_torch.models._init import Dense, lecun_normal_
from cpc_tpu_torch.ops.conv_cuda import (conv1d, conv2d, fused_conv_encoder,
                                         same_padding)
from cpc_tpu_torch.ops.ring_util import ppermute, psum, ring_perm
from cpc_tpu_torch.ops.scalogram import scalogram

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
}


class _Norm(nn.Module):
    """An encoder norm (`kind` layer, group or batch) over h (B, C, *rest),
    with a learned per-channel scale and bias, named as torch names them
    (weight, bias; flax calls them scale and bias). Statistics in fp32, the
    output rounded once to the compute dtype:

    | kind  | reduced over                                   | eps  |
    | layer | C at each position (flax LayerNorm)            | 1e-6 |
    | group | the group's channels and every axis of `rest`, |      |
    |       | min(32, C) groups (flax GroupNorm)             | 1e-6 |
    | batch | B and `rest` of the live batch, correction=0   | 1e-5 |

    The batch norm keeps no running averages, so training and eval compute
    the same (the JAX package's `_BatchStatsNorm`). With a `ring` (the
    time axis sharded over its ranks) the group and batch statistics span
    the ring: the group norm's means of x and x^2 are averaged over the
    ranks and var = max(0, E[x^2] - E[x]^2), as flax's GroupNorm computes
    under an axis name; the batch norm's sum and squared deviations are
    summed over the ranks, as `_BatchStatsNorm` computes under one."""

    def __init__(self, ch: int, kind: str, dtype, param_dtype):
        super().__init__()
        self.kind, self.dtype = kind, dtype
        self.weight = nn.Parameter(torch.ones(ch, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(ch, dtype=param_dtype))

    def forward(self, h: torch.Tensor, ring=None) -> torch.Tensor:
        x, scale, bias = h.float(), self.weight.float(), self.bias.float()
        if ring is not None and self.kind != "layer":
            return self._ring_stats(x, scale, bias, ring).to(self.dtype)
        if self.kind == "layer":
            y = F.layer_norm(x.movedim(1, -1), x.shape[1:2], scale, bias,
                             1e-6).movedim(-1, 1)
        elif self.kind == "group":
            y = F.group_norm(x, min(32, x.shape[1]), scale, bias, 1e-6)
        else:
            var, mean = torch.var_mean(x, dim=(0, *range(2, x.dim())),
                                       keepdim=True, correction=0)
            y = (x - mean) * torch.rsqrt(var + 1e-5)
            per_channel = (-1,) + (1,) * (x.dim() - 2)
            y = y * scale.view(per_channel) + bias.view(per_channel)
        return y.to(self.dtype)

    def _ring_stats(self, x, scale, bias, ring):
        per_channel = (-1,) + (1,) * (x.dim() - 2)
        if self.kind == "group":
            B, C = x.shape[:2]
            g = x.reshape(B, min(32, C), -1)
            mus = psum(torch.stack([g.mean(dim=-1), (g * g).mean(dim=-1)]),
                       ring) / ring.size
            mean, var = mus[0], torch.clamp(mus[1] - mus[0] ** 2, min=0.0)
            y = ((g - mean[..., None]) * torch.rsqrt(var[..., None] + 1e-6)
                 ).reshape(x.shape)
        else:
            red = (0, *range(2, x.dim()))
            n = float(x.numel() // x.shape[1] * ring.size)
            mean = psum(x.sum(dim=red, keepdim=True), ring) / n
            var = psum(((x - mean) ** 2).sum(dim=red, keepdim=True),
                       ring) / n
            y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * scale.view(per_channel) + bias.view(per_channel)


class _Conv(nn.Module):
    """Conv weights in torch's (out, in, *kernel) layout with flax's init
    (lecun_normal kernel, fan-in in * prod(kernel), zero bias); the padding
    is the encoder's."""

    def __init__(self, c_in: int, c_out: int, kernel: Tuple[int, ...],
                 param_dtype, generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal_(
            torch.empty(c_out, c_in, *kernel, dtype=param_dtype),
            c_in * math.prod(kernel), generator))
        self.bias = nn.Parameter(torch.zeros(c_out, dtype=param_dtype))


def _check_norm(config: EncoderConfig) -> None:
    if config.norm not in ("none", "layer", "group", "batch"):
        raise ValueError(f"unknown encoder norm {config.norm!r}; use "
                         f"none|layer|group|batch")


class ConvEncoder(nn.Module):
    """waveform (B, T) or (B, T, 1) -> z (B, T', d_enc), params in
    `param_dtype`, compute in `dtype`."""

    def __init__(self, config: EncoderConfig, dtype=torch.float32,
                 param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.kind != "conv1d":
            raise ValueError(f"ConvEncoder is the conv1d encoder, got kind "
                             f"{config.kind!r}")
        if config.remat and config.use_pallas:
            raise ValueError(
                "encoder.remat has nothing to save under encoder.use_pallas: "
                "the fused pyramid keeps no layer's activations for the "
                "backward; disable one of the two")
        _check_norm(config)
        if config.padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {config.padding!r}")
        self.config = config
        self.dtype = dtype
        self.activation = _ACTIVATIONS[config.activation]
        c_in = 1
        for i, (ch, k) in enumerate(zip(config.channels, config.kernels)):
            self.add_module(f"conv{i}", _Conv(c_in, ch, (k,), param_dtype,
                                              generator))
            if config.norm != "none":
                self.add_module(f"norm{i}", _Norm(ch, config.norm, dtype,
                                                  param_dtype))
            c_in = ch

    def _layer(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """One (conv, norm, activation) block on (B, C, T): the remat unit."""
        conv = getattr(self, f"conv{i}")
        h = conv1d(self._pad(h, i), conv.weight.to(self.dtype),
                   conv.bias.to(self.dtype), self.config.strides[i])
        return self._finish(h, i)

    def _pad(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """Layer i's input padded as the config's padding says."""
        cfg = self.config
        if cfg.padding != "SAME":
            return h
        return F.pad(h, same_padding(h.shape[-1], cfg.kernels[i],
                                     cfg.strides[i]))

    def _finish(self, h: torch.Tensor, i: int, ring=None) -> torch.Tensor:
        """Layer i's norm (its statistics over `ring` too, `_Norm`) and
        activation."""
        if self.config.norm != "none":
            h = getattr(self, f"norm{i}")(h, ring)
        return self.activation(h)

    def _cp_layer(self, h: torch.Tensor, i: int, ring) -> torch.Tensor:
        """The CP twin of _layer on this rank's (B, C, T_loc) shard: swap
        the layer's SAME-padding halo with the ring's neighbours, then
        convolve without padding."""
        cfg = self.config
        k, s = cfg.kernels[i], cfg.strides[i]
        pad = max(k - s, 0)
        pad_l, pad_r = pad // 2, pad - pad // 2
        R, me = ring.size, ring.index
        parts = []
        if pad_l:
            left = ppermute(h[..., -pad_l:], ring, ring_perm(R))
            parts.append(_zeroed(left, me == 0))
        parts.append(h)
        if pad_r:
            right = ppermute(h[..., :pad_r], ring,
                             [((j + 1) % R, j) for j in range(R)])
            parts.append(_zeroed(right, me == R - 1))
        h = torch.cat(parts, dim=-1) if len(parts) > 1 else h
        conv = getattr(self, f"conv{i}")
        h = conv1d(h, conv.weight.to(self.dtype), conv.bias.to(self.dtype), s)
        return self._finish(h, i, ring)

    def _cp_forward(self, x: torch.Tensor, ring) -> torch.Tensor:
        """This rank's shard of the waveform, (B, S_loc) or (B, S_loc, 1),
        -> its shard of z (B, S_loc // prod(strides), C), under context
        parallelism over `ring`."""
        cfg = self.config
        if cfg.padding != "SAME" or cfg.use_pallas:
            raise ValueError(
                "CP encoder requires padding='SAME' and use_pallas=False "
                f"(got padding={cfg.padding!r}, use_pallas={cfg.use_pallas})")
        if x.dim() == 3:
            x = x[..., 0]
        stride_prod = math.prod(cfg.strides)
        if x.shape[1] % stride_prod:
            raise ValueError(
                f"CP encoder: local T {x.shape[1]} must divide by "
                f"prod(strides)={stride_prod}")
        h = x.to(self.dtype)[:, None, :]
        for i in range(len(cfg.kernels)):
            if cfg.remat and torch.is_grad_enabled():
                h = checkpoint(self._cp_layer, h, i, ring,
                               use_reentrant=False)
            else:
                h = self._cp_layer(h, i, ring)
        return h.transpose(1, 2)

    def forward(self, x: torch.Tensor, layer=None) -> torch.Tensor:
        """`layer(h, i)` runs block i, `_layer` unless tensor parallelism
        (`parallel/tp.py`) passes its own; use_pallas runs the kernels."""
        cfg = self.config
        if x.dim() == 3:
            x = x[..., 0]
        x = x.to(self.dtype)
        if cfg.use_pallas:
            if (cfg.padding != "SAME" or cfg.norm != "none"
                    or cfg.activation != "relu"):
                raise ValueError(
                    "the fused conv pyramid supports SAME padding, no norm, "
                    "relu only; disable encoder.use_pallas for this config")
            convs = [getattr(self, f"conv{i}")
                     for i in range(len(cfg.kernels))]
            # the cast writes the kernels' (C_out, k, C_in) layout, so that
            # it is the one copy of a weight a forward makes
            return fused_conv_encoder(
                x, [c.weight.permute(0, 2, 1).to(
                    self.dtype, memory_format=torch.contiguous_format
                ).permute(0, 2, 1) for c in convs],
                [c.bias.to(self.dtype) for c in convs], cfg.kernels,
                cfg.strides)
        layer = layer or self._layer
        h = x[:, None, :]  # (B, 1, T)
        for i in range(len(cfg.kernels)):
            if cfg.remat and torch.is_grad_enabled():
                h = checkpoint(layer, h, i, use_reentrant=False)
            else:
                h = layer(h, i)
        return h.transpose(1, 2)  # (B, T', C)


def _zeroed(x: torch.Tensor, zero: bool) -> torch.Tensor:
    """x, or zeros in its place where `zero`: by arithmetic, so that the
    tensor stays in the graph and its sender's backward still runs."""
    flag = torch.tensor(zero, device=x.device)
    return torch.where(flag, torch.zeros((), dtype=x.dtype, device=x.device),
                       x)


class ScalogramEncoder(nn.Module):
    """Music-audio encoder: waveform (B, T) or (B, T, 1) -> log-power
    scalogram (B, T // hop, n_bins), computed on the input's device in fp32
    (`ops/scalogram.py`), -> a Conv2d stack over (time, freq) -> z (B, T',
    d_enc). Params in `param_dtype`, the convs and `proj` in `dtype`.

    Block i is conv2d_{i} (kernel (kt, kf), strides (time_strides[i],
    freq_strides[i]), flax's SAME padding on each axis: on a strided axis
    it is asymmetric, (0, 1) for 128 -> 64 at k = 3), then norm{i}, then
    the activation; a block is the remat unit under `remat`, and the DSP
    stays outside it. The convs run on (B, C, T, F); the last block's
    (F', C) fold into F' * C features, frequency-major as flax's NHWC
    reshape gives them, before `proj`. Like the JAX module it ignores
    `padding` (always SAME) and `use_pallas` (no kernel of its own)."""

    def __init__(self, config: EncoderConfig, dtype=torch.float32,
                 param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.kind != "scalogram":
            raise ValueError(f"ScalogramEncoder is the scalogram encoder, "
                             f"got kind {config.kind!r}")
        _check_norm(config)
        self.config = config
        self.dtype = dtype
        self.activation = _ACTIVATIONS[config.activation]
        self.geometry = list(zip(
            config.scalogram_kernels, config.scalogram_time_strides,
            config.scalogram_freq_strides, config.scalogram_channels))
        c_in, n_freq = 1, config.scalogram_n_bins
        for i, (k, _, fs, ch) in enumerate(self.geometry):
            self.add_module(f"conv2d_{i}", _Conv(c_in, ch, tuple(k),
                                                 param_dtype, generator))
            if config.norm != "none":
                self.add_module(f"norm{i}", _Norm(ch, config.norm, dtype,
                                                  param_dtype))
            c_in, n_freq = ch, -(-n_freq // fs)
        self.proj = Dense(n_freq * c_in, config.d_enc, dtype, param_dtype,
                          generator)

    def _layer(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """One (conv2d, norm, activation) block on (B, C, T, F)."""
        _, ts, fs, _ = self.geometry[i]
        conv = getattr(self, f"conv2d_{i}")
        h = conv2d(self._pad(h, i), conv.weight.to(self.dtype),
                   conv.bias.to(self.dtype), (ts, fs))
        return self._finish(h, i)

    def _pad(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """Block i's input with flax's SAME padding on time and freq."""
        (kt, kf), ts, fs, _ = self.geometry[i]
        return F.pad(h, same_padding(h.shape[-1], kf, fs)
                     + same_padding(h.shape[-2], kt, ts))

    def _finish(self, h: torch.Tensor, i: int, ring=None) -> torch.Tensor:
        """Block i's norm (statistics over `ring` too) and activation."""
        if self.config.norm != "none":
            h = getattr(self, f"norm{i}")(h, ring)
        return self.activation(h)

    def forward(self, x: torch.Tensor, layer=None) -> torch.Tensor:
        """`layer(h, i)` runs block i, `_layer` unless tensor parallelism
        passes its own."""
        cfg = self.config
        if x.dim() == 3:
            x = x[..., 0]
        s = scalogram(x.float(), n_fft=cfg.scalogram_n_fft,
                      hop=cfg.scalogram_hop, n_bins=cfg.scalogram_n_bins,
                      fmin=cfg.scalogram_fmin, fmax=cfg.scalogram_fmax,
                      scale=cfg.scalogram_scale, sample_rate=16_000)
        layer = layer or self._layer
        h = s[:, None].to(self.dtype)  # (B, 1, T, F)
        for i in range(len(self.geometry)):
            if cfg.remat and torch.is_grad_enabled():
                h = checkpoint(layer, h, i, use_reentrant=False)
            else:
                h = layer(h, i)
        B, C, T, n_freq = h.shape
        return self.proj(h.permute(0, 2, 3, 1).reshape(B, T, n_freq * C))


def make_encoder(config: EncoderConfig, dtype=torch.float32,
                 param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    if config.kind == "conv1d":
        return ConvEncoder(config, dtype, param_dtype, generator)
    if config.kind == "scalogram":
        return ScalogramEncoder(config, dtype, param_dtype, generator)
    raise ValueError(f"unknown encoder kind {config.kind!r}")


def encoder_width(config: EncoderConfig) -> int:
    """The width of the encoder's z, which flax infers for the gar: `proj`'s
    d_enc for the scalogram encoder, the last conv's channels for conv1d."""
    return config.d_enc if config.kind == "scalogram" else config.channels[-1]
