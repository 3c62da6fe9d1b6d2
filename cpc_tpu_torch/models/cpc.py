"""CPC wrapper model: encoder (genc) + GRU context network (gar) + K
prediction heads W_k.

Port of `cpc_tpu/models/cpc.py::CPCModel`, GRU gar and conv1d encoder only.
The K heads are ONE bias-free linear map d_ar -> K*d_enc, reshaped to
(B, T, K, d_enc). Params are kept in `param_dtype` (fp32 masters) and cast
to the compute `dtype` at use, as flax does: bf16 compute under `tpu_fast`.
The transformer gar and the scalogram encoder raise (ROADMAP.md §A12).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cpc_tpu_torch.config import ModelConfig
from cpc_tpu_torch.models._init import lecun_normal_
from cpc_tpu_torch.models.encoder import ConvEncoder
from cpc_tpu_torch.models.gru import GRU

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class CPCOutput(NamedTuple):
    z: torch.Tensor      # (B, T, d_enc) encoder latents
    c: torch.Tensor      # (B, T, d_ar) autoregressive context
    preds: torch.Tensor  # (B, T, K, d_enc) k-step predictions W_k c_t


class CPCModel(nn.Module):
    """Params are drawn on the CPU from `generator` (so a seed gives the
    same weights on any device) and then moved to `device`."""

    def __init__(self, config: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.encoder.kind != "conv1d":
            raise NotImplementedError(
                f"encoder kind {config.encoder.kind!r} is not ported yet: "
                f"ROADMAP.md §A12 (scalogram)")
        if config.ar.kind != "gru":
            raise NotImplementedError(
                f"ar kind {config.ar.kind!r} is not ported yet: ROADMAP.md "
                f"§A12 (transformer gar)")
        if config.ar.remat:
            raise ValueError("ar.remat requires the transformer gar")
        self.config = config
        self.dtype = DTYPES[config.dtype]
        param_dtype = DTYPES[config.param_dtype]
        self.encoder = ConvEncoder(config.encoder, self.dtype, param_dtype,
                                   generator)
        self.gar = GRU(config.encoder.channels[-1], config.ar.d_ar,
                       config.ar.num_layers, self.dtype, param_dtype,
                       generator)
        K, d_enc = config.loss.prediction_steps, config.encoder.d_enc
        self.prediction_heads = nn.utils.skip_init(
            nn.Linear, config.ar.d_ar, K * d_enc, bias=False,
            dtype=param_dtype)
        lecun_normal_(self.prediction_heads.weight, config.ar.d_ar, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> CPCOutput:
        """x: waveform (B, T_samples) or (B, T_samples, 1)."""
        z, c = self.latents(x)
        B, T, _ = c.shape
        preds = self.predict(c).reshape(B, T, self.config.loss.prediction_steps,
                                        self.config.encoder.d_enc)
        return CPCOutput(z=z, c=c, preds=preds)

    def latents(self, x: torch.Tensor):
        """(z, c) without the prediction heads."""
        z = self.encoder(x)
        return z, self.gar(z)

    def latents_tm(self, x: torch.Tensor):
        """(z (B, T, d_enc), c_tm (T, B, d_ar)): c in the time-major layout
        the fused heads + InfoNCE loss takes, which is the recurrence's own
        output layout, so no transpose is made on either side."""
        z = self.encoder(x)
        return z, self.gar(z, time_major_out=True)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Standalone latents z (feature-extraction API)."""
        return self.encoder(x)

    def context(self, x: torch.Tensor) -> torch.Tensor:
        """Standalone context c (feature-extraction API)."""
        return self.gar(self.encoder(x))

    def predict(self, c: torch.Tensor) -> torch.Tensor:
        """K-step predictions from context: (B, T, K*d_enc)."""
        return F.linear(c, self.prediction_heads.weight.to(self.dtype))

    def context_with_state(self, z: torch.Tensor,
                           h0: Optional[torch.Tensor] = None):
        """(c, final GRU hidden (num_layers, B, H)) from latents z: the
        state carry of streaming extraction."""
        return self.gar(z, h0=h0, return_state=True)
