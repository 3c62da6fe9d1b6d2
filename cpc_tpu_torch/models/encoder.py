"""genc: strided Conv1d encoder over the raw waveform.

Port of `cpc_tpu/models/encoder.py::ConvEncoder` (conv1d kind): 5 Conv1d
layers, channels 512, kernels (10, 8, 4, 4, 4), strides (5, 4, 2, 2, 2),
160x downsampling, ReLU. The public layout is the JAX package's (B, T, C);
inside, the convs run on (B, C, T) as `F.conv1d` expects.

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
parameters are the same on both routes). Waiting (ROADMAP.md §A13): the
context-parallel halo path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cpc_tpu_torch.config import EncoderConfig
from cpc_tpu_torch.models._init import lecun_normal_
from cpc_tpu_torch.ops.conv_cuda import (conv1d, fused_conv_encoder,
                                         same_padding)

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
}


class _Norm(nn.Module):
    """Learned per-channel scale and bias of a norm over (B, T, C); the
    statistics are the encoder's (`ConvEncoder._normalize`). Named as
    torch names them (weight, bias); flax calls them scale and bias."""

    def __init__(self, ch: int, param_dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(ch, dtype=param_dtype))


class _Conv1d(nn.Module):
    """Conv1d weights in torch's (out, in, k) layout with flax's init
    (lecun_normal kernel, zero bias); the padding is the encoder's."""

    def __init__(self, c_in: int, c_out: int, k: int, param_dtype,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal_(
            torch.empty(c_out, c_in, k, dtype=param_dtype), c_in * k,
            generator))
        self.bias = nn.Parameter(torch.zeros(c_out, dtype=param_dtype))


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
        if config.norm not in ("none", "layer", "group", "batch"):
            raise ValueError(f"unknown encoder norm {config.norm!r}; use "
                             f"none|layer|group|batch")
        if config.padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {config.padding!r}")
        self.config = config
        self.dtype = dtype
        self.activation = _ACTIVATIONS[config.activation]
        c_in = 1
        for i, (ch, k) in enumerate(zip(config.channels, config.kernels)):
            self.add_module(f"conv{i}", _Conv1d(c_in, ch, k, param_dtype,
                                                generator))
            if config.norm != "none":
                self.add_module(f"norm{i}", _Norm(ch, param_dtype))
            c_in = ch

    def _normalize(self, h: torch.Tensor, norm: _Norm) -> torch.Tensor:
        """h (B, C, T) normalized in fp32 and rounded to the compute dtype.
        layer: over C at each position; group: over T and the group's
        channels of each sequence; batch: over (B, T) of the live batch."""
        kind = self.config.norm
        x, scale, bias = h.float(), norm.weight.float(), norm.bias.float()
        if kind == "layer":
            y = F.layer_norm(x.transpose(1, 2), x.shape[1:2], scale, bias,
                             1e-6).transpose(1, 2)
        elif kind == "group":
            y = F.group_norm(x, min(32, x.shape[1]), scale, bias, 1e-6)
        else:
            var, mean = torch.var_mean(x, dim=(0, 2), keepdim=True,
                                       correction=0)
            y = (x - mean) * torch.rsqrt(var + 1e-5)
            y = y * scale[:, None] + bias[:, None]
        return y.to(self.dtype)

    def _layer(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """One (conv, norm, activation) block on (B, C, T): the remat unit."""
        cfg = self.config
        conv = getattr(self, f"conv{i}")
        k, s = cfg.kernels[i], cfg.strides[i]
        if cfg.padding == "SAME":
            h = F.pad(h, same_padding(h.shape[-1], k, s))
        h = conv1d(h, conv.weight.to(self.dtype), conv.bias.to(self.dtype), s)
        if cfg.norm != "none":
            h = self._normalize(h, getattr(self, f"norm{i}"))
        return self.activation(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
        h = x[:, None, :]  # (B, 1, T)
        for i in range(len(cfg.kernels)):
            if cfg.remat and torch.is_grad_enabled():
                h = checkpoint(self._layer, h, i, use_reentrant=False)
            else:
                h = self._layer(h, i)
        return h.transpose(1, 2)  # (B, T', C)
