"""genc: strided Conv1d encoder over the raw waveform.

Port of `cpc_tpu/models/encoder.py::ConvEncoder` (conv1d kind): 5 Conv1d
layers, channels 512, kernels (10, 8, 4, 4, 4), strides (5, 4, 2, 2, 2),
160x downsampling, ReLU. The public layout is the JAX package's (B, T, C);
inside, the convs run on (B, C, T) as `F.conv1d` expects.

SAME padding is flax's, which `Conv1d(padding='same')` cannot give for a
stride above 1: for t_out = ceil(t_in / s) the total padding is
max((t_out - 1) * s + k - t_in, 0), split (total // 2, rest). It gives
exactly T // 160 latents (20480 -> 128); VALID gives 126.

Taken from the JAX encoder: padding SAME | VALID, norm none | layer (flax
LayerNorm, eps 1e-6), activation relu | gelu (tanh form, as flax) | tanh.
Waiting (ROADMAP.md §A3, §B5): norms group and batch, `remat`, the
context-parallel halo path and the fused conv pyramid (`use_pallas`);
they raise here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cpc_tpu_torch.config import EncoderConfig
from cpc_tpu_torch.models._init import lecun_normal_

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
}


def same_padding(t_in: int, k: int, s: int):
    """(left, right) zeros of flax's SAME padding for one strided conv."""
    t_out = -(-t_in // s)
    total = max((t_out - 1) * s + k - t_in, 0)
    return total // 2, total - total // 2


def _conv1d(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int) -> torch.Tensor:
    """F.conv1d, except for reduced precision on the CPU: there oneDNN's
    bf16 conv1d (torch 2.13) returns wrong values for some lengths (an
    input length divisible by the stride, measured off by up to 5 at
    outputs of magnitude 5), so the CPU runs the product in fp32 and rounds
    it once, which is what a bf16 conv with fp32 accumulation computes, in
    the backward too."""
    if h.device.type == "cpu" and h.dtype != torch.float32:
        return F.conv1d(h.float(), w.float(), b.float(),
                        stride=stride).to(h.dtype)
    return F.conv1d(h, w, b, stride=stride)


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
        if config.use_pallas:
            raise NotImplementedError(
                "encoder.use_pallas selects the fused conv pyramid kernel "
                "(cpc_tpu/ops/conv_pallas.py), not ported yet: ROADMAP.md "
                "§B5")
        if config.remat:
            raise NotImplementedError("encoder.remat is not ported yet: "
                                      "ROADMAP.md §A3")
        if config.norm in ("group", "batch"):
            raise NotImplementedError(f"encoder norm {config.norm!r} is not "
                                      f"ported yet: ROADMAP.md §A3")
        if config.norm not in ("none", "layer"):
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
            if config.norm == "layer":
                self.add_module(f"norm{i}", nn.LayerNorm(
                    ch, eps=1e-6, dtype=param_dtype))
            c_in = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if x.dim() == 3:
            x = x[..., 0]
        h = x.to(self.dtype)[:, None, :]  # (B, 1, T)
        for i, (k, s) in enumerate(zip(cfg.kernels, cfg.strides)):
            conv = getattr(self, f"conv{i}")
            if cfg.padding == "SAME":
                h = F.pad(h, same_padding(h.shape[-1], k, s))
            h = _conv1d(h, conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype), s)
            if cfg.norm == "layer":
                norm = getattr(self, f"norm{i}")
                h = F.layer_norm(h.transpose(1, 2).float(), norm.normalized_shape,
                                 norm.weight.float(), norm.bias.float(),
                                 norm.eps).to(self.dtype).transpose(1, 2)
            h = self.activation(h)
        return h.transpose(1, 2)  # (B, T', C)
