"""Constant-memory streaming feature extraction (the real-time consumer).

Port of `cpc_tpu/eval/streaming.py`. `extract_features` computes
trajectories over a finite stream in sliding windows; `StreamingExtractor`
carries exact state across arbitrary chunks instead:

  * encoder: a residual sample buffer. The conv pyramid is applied with
    VALID padding over `residual + chunk` and emits exactly the latents
    whose full receptive field is available, equal to a VALID forward over
    the whole stream (the stride pyramid consumes blocks of `downsample`
    samples exactly, so chunk boundaries never shift alignment).
  * gar: the GRU hidden state (num_layers, n_streams, H) is threaded
    between chunks through `CPCModel.context_with_state`, whose recurrence
    is `ops.gru_cuda.gru_scan` (the CUDA kernel on the card, fp32, h0 the
    previous push's state). The transformer carries `decode_carry`'s KV
    cache with a position per stream and runs `decode_step` once per
    latent, plain tensor code; a stream is bounded by `ar.max_len` latents
    and raises where the offline forward would.

Contracts, as in the JAX package:
  * VALID semantics: equal to the SAME forward except at the zero-padded
    stream edges.
  * Normalization: training normalizes per snippet, which a stream cannot
    reproduce. Pass corpus-level `stats=(mean, std)` for a fixed affine
    normalization, or None for raw samples. Encoder norms whose statistics
    span the time axis ('batch', 'group') are rejected; 'layer' streams.
  * fp32 whatever the training dtype, and fp32 on the card too: the
    extractor's forward runs with TF32 off in cuDNN and cuBLAS, set around
    its own calls and restored after (torch's default lets cuDNN's convs
    run TF32).
  * reset_stream(i) restarts one row of a lockstep batch; the new stream
    behaves as if preceded by the shared residual's length of zeros.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cpc_tpu_torch.config import ModelConfig
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.models.encoder import encoder_width
from cpc_tpu_torch.models.transformer import carry_decode_model, decode_carry


def receptive_field(kernels, strides) -> Tuple[int, int]:
    """(receptive_field, total_downsample) of a strided conv pyramid:
    latent t depends on samples [t*down, t*down + rf)."""
    rf, jump = 1, 1
    for k, s in zip(kernels, strides):
        rf += (k - 1) * jump
        jump *= s
    return rf, jump


def portable_stream_model(cfg: ModelConfig, device=None) -> CPCModel:
    """The streaming clone of a model config: VALID padding, fp32 compute,
    the plain encoder (`use_pallas=False`) and `attn_impl='xla'`. Its
    parameter tree is the config's own (padding, dtype and kernel flags do
    not change parameter shapes), so `load_state_dict` of the trained
    model's state loads unchanged. Rejects the encoders that cannot
    stream."""
    if cfg.encoder.kind != "conv1d":
        raise ValueError(
            "streaming extraction supports the conv1d encoder only "
            f"(got {cfg.encoder.kind!r}); the scalogram front-end is "
            "frame-based — use windowed extract_features")
    if cfg.encoder.norm in ("batch", "group"):
        raise ValueError(
            f"encoder norm {cfg.encoder.norm!r} computes statistics over "
            "the time axis, so chunked output would silently diverge "
            "from the offline forward; streaming supports norm "
            "'none'/'layer' (use windowed extract_features otherwise)")
    enc = dataclasses.replace(cfg.encoder, padding="VALID", use_pallas=False)
    ar = dataclasses.replace(cfg.ar, use_pallas=False, attn_impl="xla")
    return CPCModel(dataclasses.replace(cfg, encoder=enc, ar=ar,
                                        dtype="float32"), device=device)


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuDNN and cuBLAS inside the block; the caller's
    settings are restored after."""
    kept = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = kept


class StreamingExtractor:
    """Feed chunks with push(), collect (z, c) increments; reset() restarts.

    Equality contract (tested): concatenating every push()'s outputs equals
    the offline VALID forward of the concatenated stream."""

    def __init__(self, model: CPCModel, *,
                 stats: Optional[Tuple[float, float]] = None,
                 n_streams: int = 1):
        """Runs on the device of `model`'s parameters, with its weights
        copied into the fp32 streaming clone. n_streams > 1 serves that
        many INDEPENDENT streams in lockstep: every push carries one
        equal-length chunk per stream, (n_streams, T), and returns
        (n_streams, n, d)."""
        cfg = model.config
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.n_streams = n_streams
        if cfg.ar.kind not in ("gru", "transformer"):
            raise ValueError(f"unknown gar kind {cfg.ar.kind!r}")
        self.device = next(model.parameters()).device
        self._model = portable_stream_model(cfg, self.device)
        self._model.load_state_dict(model.state_dict())
        self._model.eval()
        self.rf, self.down = receptive_field(cfg.encoder.kernels,
                                             cfg.encoder.strides)
        self.d_enc, self.d_ar = cfg.encoder.d_enc, cfg.ar.d_ar
        if stats is not None:
            m, s = float(stats[0]), float(stats[1])
            if not (np.isfinite(m) and np.isfinite(s) and s > 0):
                raise ValueError(
                    f"stats=(mean, std) needs a finite positive std, got "
                    f"({m}, {s}) — (win - mean)/std would emit NaN/inf "
                    "frames forever")
            stats = (m, s)
        self._stats = stats
        self._is_tr = cfg.ar.kind == "transformer"
        if self._is_tr:
            ar = self._model.config.ar
            # the decode twin: the gar's parameters on the module that has
            # the KV-cache step
            self._tr = carry_decode_model(encoder_width(cfg.encoder), ar)
            self._tr.load_state_dict(self._model.gar.state_dict())
            self._tr.to(self.device).eval()
            self.max_latents = ar.max_len
        self.reset()

    def reset(self) -> None:
        self._resid = np.zeros((self.n_streams, 0), np.float32)
        self._h = None  # GRU: (num_layers, n_streams, H) after first push
        if self._is_tr:
            self._carry = decode_carry(self._model.config.ar, self.n_streams,
                                       device=self.device)
            self._n_seen = np.zeros((self.n_streams,), np.int64)

    def reset_stream(self, i: int) -> None:
        """Recycle batch row `i` for a NEW stream without disturbing the
        others. The row's gar state restarts (GRU: its hidden row zeroes;
        transformer: its carry position returns to 0, which masks every
        stale KV entry beyond it) and its residual samples zero in place, so
        the new stream's outputs equal a fresh extractor fed
        `zeros(len(residual))` + the later chunks."""
        if not 0 <= i < self.n_streams:
            raise ValueError(f"stream index {i} out of range "
                             f"[0, {self.n_streams})")
        if self._is_tr:
            self._carry["pos"][i] = 0
            self._n_seen[i] = 0
        self._resid[i] = 0.0
        if self._h is not None:
            self._h[:, i, :] = 0.0

    def push(self, chunk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """chunk (T,) — or (n_streams, T) for a batched extractor — float32
        -> (z (n_new, d_enc), c (n_new, d_ar)), batched shapes
        (n_streams, n_new, d) when n_streams > 1; n_new is however many
        latents' receptive fields completed, possibly 0."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim == 1 and self.n_streams == 1:
            chunk = chunk[None]
        if chunk.ndim != 2 or chunk.shape[0] != self.n_streams:
            raise ValueError(
                f"chunk must be (T,) for one stream or ({self.n_streams}, T)"
                f"; got shape {chunk.shape}")
        buf = np.concatenate([self._resid, chunk], axis=1)
        L = buf.shape[1]
        cfg = self._model.config
        if L < self.rf:
            self._resid = buf
            lead = () if self.n_streams == 1 else (self.n_streams,)
            return (np.zeros(lead + (0, cfg.encoder.d_enc), np.float32),
                    np.zeros(lead + (0, cfg.ar.d_ar), np.float32))
        n = (L - self.rf) // self.down + 1
        if self._is_tr and (self._n_seen + n > self.max_latents).any():
            worst = int(self._n_seen.max()) + n
            raise ValueError(
                f"stream exceeds the transformer's positional table: "
                f"{worst} latents > max_len {self.max_latents} (the offline "
                f"forward rejects the same length); reset()/reset_stream() "
                f"or raise ar.max_len")
        window = torch.from_numpy(
            np.ascontiguousarray(buf[:, :self.rf + (n - 1) * self.down])
        ).to(self.device)
        with torch.no_grad(), fp32_exact():
            if self._stats is not None:
                mean, std = self._stats
                window = (window - mean) / std
            z = self._model.encode(window)
            if self._is_tr:
                cs = []
                for t in range(n):
                    c_t, self._carry = self._tr.decode_step(z[:, t],
                                                            self._carry)
                    cs.append(c_t)
                c = torch.stack(cs, dim=1)
                self._n_seen += n
            else:
                c, self._h = self._model.context_with_state(z, self._h)
            z_np = z.float().cpu().numpy()
            c_np = c.float().cpu().numpy()
        self._resid = buf[:, n * self.down:]
        if self.n_streams == 1:
            return z_np[0], c_np[0]
        return z_np, c_np

    @property
    def pending_samples(self) -> int:
        """Samples held for the next push (the residual buffer)."""
        return int(self._resid.shape[1])
