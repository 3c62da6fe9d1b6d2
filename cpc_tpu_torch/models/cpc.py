"""CPC wrapper model: encoder (genc) + context network (gar: a GRU or a
causal transformer) + K prediction heads W_k.

Port of `cpc_tpu/models/cpc.py::CPCModel` with the conv1d encoder. The K
heads are ONE bias-free linear map d_ar -> K*d_enc, reshaped to
(B, T, K, d_enc). Params are kept in `param_dtype` (fp32 masters) and cast
to the compute `dtype` at use, as flax does: bf16 compute under `tpu_fast`
and `transformer_fast`. `train` and `generator` reach the transformer gar
for its dropout (live only when train=True) and mean nothing to the GRU.
The scalogram encoder raises (ROADMAP.md §A12).
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
from cpc_tpu_torch.models.transformer import CausalTransformer

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
        self.config = config
        self.dtype = DTYPES[config.dtype]
        param_dtype = DTYPES[config.param_dtype]
        self.encoder = ConvEncoder(config.encoder, self.dtype, param_dtype,
                                   generator)
        d_in = config.encoder.channels[-1]
        if config.ar.kind == "gru":
            if config.ar.remat:
                raise ValueError(
                    "ar.remat requires the transformer gar: the GRU's "
                    "recurrence keeps its per-step carries for the backward "
                    "pass either way")
            self.gar = GRU(d_in, config.ar.d_ar, config.ar.num_layers,
                           self.dtype, param_dtype, generator,
                           config.ar.use_pallas)
        elif config.ar.kind == "transformer":
            self.gar = CausalTransformer(d_in, config.ar, self.dtype,
                                         param_dtype, generator)
        else:
            raise ValueError(f"unknown ar kind {config.ar.kind!r}")
        K, d_enc = config.loss.prediction_steps, config.encoder.d_enc
        self.prediction_heads = nn.utils.skip_init(
            nn.Linear, config.ar.d_ar, K * d_enc, bias=False,
            dtype=param_dtype)
        lecun_normal_(self.prediction_heads.weight, config.ar.d_ar, generator)
        self.to(device)

    def _gar(self, z: torch.Tensor, train: bool, generator) -> torch.Tensor:
        if self.config.ar.kind == "transformer":
            return self.gar(z, train=train, generator=generator)
        return self.gar(z)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> CPCOutput:
        """x: waveform (B, T_samples) or (B, T_samples, 1)."""
        z, c = self.latents(x, train, generator)
        B, T, _ = c.shape
        preds = self.predict(c).reshape(B, T, self.config.loss.prediction_steps,
                                        self.config.encoder.d_enc)
        return CPCOutput(z=z, c=c, preds=preds)

    def latents(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """(z, c) without the prediction heads."""
        z = self.encoder(x)
        return z, self._gar(z, train, generator)

    def latents_tm(self, x: torch.Tensor, train: bool = False,
                   generator: Optional[torch.Generator] = None):
        """(z (B, T, d_enc), c_tm (T, B, d_ar)): c in the time-major layout
        the fused heads + InfoNCE loss takes. For the GRU that is the
        recurrence's own output layout, so no transpose is made on either
        side; the transformer keeps (B, T, d_ar) inside and c is transposed
        once here (a view: the loss makes it contiguous)."""
        z = self.encoder(x)
        if self.config.ar.kind == "gru":
            return z, self.gar(z, time_major_out=True)
        return z, self._gar(z, train, generator).transpose(0, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Standalone latents z (feature-extraction API)."""
        return self.encoder(x)

    def context(self, x: torch.Tensor) -> torch.Tensor:
        """Standalone context c (feature-extraction API)."""
        return self._gar(self.encoder(x), False, None)

    def predict(self, c: torch.Tensor) -> torch.Tensor:
        """K-step predictions from context: (B, T, K*d_enc)."""
        return F.linear(c, self.prediction_heads.weight.to(self.dtype))

    def context_with_state(self, z: torch.Tensor,
                           h0: Optional[torch.Tensor] = None):
        """(c, final GRU hidden (num_layers, B, H)) from latents z: the
        state carry of streaming extraction. GRU gar only: a causal
        transformer has no constant-size recurrent state to carry."""
        if self.config.ar.kind != "gru":
            raise ValueError(
                "context_with_state requires the GRU gar; the transformer "
                "variant has no constant-size carry (use windowed "
                "extract_features instead)")
        return self.gar(z, h0=h0, return_state=True)
