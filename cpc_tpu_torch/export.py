"""Serving export: freeze a model and its weights into a portable
`torch.export` artifact.

Port of `cpc_tpu/export.py`. The JAX package bakes the trained parameters
into a serialized StableHLO computation; here the same function is traced
by `torch.export` into an `ExportedProgram` with the weights in it, saved
as a `.pt2` file (`torch.export.save`) beside a `PATH.json` sidecar. A
serving host needs torch and the file: not this package, not the
checkpoint. The program is traced on one device and runs on the CPU or on
a CUDA device (`load_artifact(path, device=...)`), as the JAX artifact is
lowered for cpu and tpu.

Two artifacts, matching the two consumer APIs:

  * `export_extractor`: the windowed extractor, f(x (B, S) fp32) ->
    (z (B, T, d_enc), c (B, T, d_ar)), with `ops.dsp.prepare_waveform`
    (dequantization and the per-snippet normalization, population
    variance) folded in. The batch is symbolic (`torch.export.Dim`) unless
    pinned.
  * `export_streaming_step`: the fixed-shape step of
    `eval.streaming.StreamingExtractor` on its portable model (VALID
    padding, fp32): f(h, window) -> (z, c, h') for the GRU; for the
    transformer f(k, v, pos, window) -> (z, c, k', v', pos') over the KV
    cache of `models.transformer.decode_carry`, with k and v stacked
    (num_layers, n_streams, max_len, H, Dh) and pos int32 as the JAX
    server builds it. The host keeps the residual sample buffer, threads
    the state from zeros and, for the transformer, stops a stream before
    `max_len` latents: past the positional table the index is out of
    range (a device-side assert on CUDA, where XLA clamps).

The artifact holds no hand-written kernel (`"kernels": "plain"` in the
sidecar): the encoder runs `encoder.use_pallas=False`, attention
`attn_impl='xla'`, and while a graph is exported
(`torch.compiler.is_exporting()`) the GRU runs its plain recurrence
(`models.gru`) and a reduced-precision conv its fp32 product rounded once
on either device (`ops.conv_cuda.conv1d`). The kernels are
launched through ctypes, which `torch.export` cannot trace, and an
artifact that called them would need this package's built libraries to
load; the JAX package routes its Pallas kernels off in exports for the
same reason. The live paths (training, `extract_features`,
`StreamingExtractor`) keep the kernels.

A program's convs follow the cuDNN settings of the process that calls
it, and torch's default lets cuDNN take TF32 for fp32 convs: a streaming
step agrees with `StreamingExtractor` at fp32 when it is called with TF32
off (`utils.precision.fp32_exact`), as `serve --artifact` calls it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Tuple

import torch
from torch import nn
from torch.export import Dim, ExportedProgram
from torch.export.passes import move_to_device_pass

from cpc_tpu_torch.eval.streaming import (portable_stream_model,
                                          receptive_field)
from cpc_tpu_torch.models.cpc import DTYPES, CPCModel
from cpc_tpu_torch.models.encoder import encoder_width
from cpc_tpu_torch.models.transformer import carry_decode_model
from cpc_tpu_torch.ops.dsp import prepare_waveform

FORMAT_VERSION = 1
PLATFORMS = ("cpu", "cuda")
# the sidecar's dtype names, as JAX prints an aval (f32[b,20480])
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.int32: "i32", torch.int64: "i64"}


def _frozen(model: CPCModel) -> CPCModel:
    """`model` in eval mode with its parameters out of autograd."""
    return model.eval().requires_grad_(False)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _portable_model(model: CPCModel) -> CPCModel:
    """The same weights on the plain path: `encoder.use_pallas` and
    `ar.use_pallas` off, `attn_impl='xla'`, so that the graph calls no
    kernel of this package (the GRU and the conv route on
    `torch.compiler.is_exporting()`)."""
    cfg = model.config
    enc = dataclasses.replace(cfg.encoder, use_pallas=False)
    ar = dataclasses.replace(cfg.ar, use_pallas=False, attn_impl="xla")
    # its own generator for the initial draws, which the load overwrites:
    # torch's global one is left alone
    m = CPCModel(dataclasses.replace(cfg, encoder=enc, ar=ar),
                 device=_device(model),
                 generator=torch.Generator().manual_seed(0))
    m.load_state_dict(model.state_dict())
    return _frozen(m)


def _cast_params(model: CPCModel, dtype_name: Optional[str]) -> CPCModel:
    """The floating parameters in `dtype_name` ('float32' | 'bfloat16'), the
    compute dtype unchanged (each module casts its weights at use)."""
    if dtype_name is None:
        return model
    return model.to(DTYPES[dtype_name])


class _Extractor(nn.Module):
    def __init__(self, model: CPCModel, normalize: bool):
        super().__init__()
        self.model, self.normalize = model, normalize

    def forward(self, x):
        return self.model.latents(prepare_waveform(x, self.normalize))


class _Normalized(nn.Module):
    """A step's encoder input: the window, or (window - mean) / std."""

    def __init__(self, model: CPCModel, stats):
        super().__init__()
        self.model, self.stats = model, stats

    def encode(self, win):
        if self.stats is not None:
            win = (win - self.stats[0]) / self.stats[1]
        return self.model.encode(win)


class _GruStep(_Normalized):
    def forward(self, h, win):
        z = self.encode(win)
        c, h2 = self.model.context_with_state(z, h)
        return z, c, h2


class _TransformerStep(_Normalized):
    def __init__(self, model: CPCModel, stats, decoder):
        super().__init__(model, stats)
        self.decoder = decoder

    def forward(self, k, v, pos, win):
        z = self.encode(win)
        L = k.shape[0]
        # decode_step writes each layer's cache in place: on copies, so
        # that the program leaves its inputs as they were
        carry = {"k": tuple(k[i].clone() for i in range(L)),
                 "v": tuple(v[i].clone() for i in range(L)),
                 "pos": pos.long()}
        cs = []
        for t in range(z.shape[1]):
            c_t, carry = self.decoder.decode_step(z[:, t], carry)
            cs.append(c_t)
        return (z, torch.stack(cs, dim=1), torch.stack(carry["k"]),
                torch.stack(carry["v"]), carry["pos"].to(torch.int32))


def export_extractor(model: CPCModel, *, snippet_samples: int,
                     batch: Optional[int] = None, normalize: bool = True,
                     params_dtype: Optional[str] = None) -> ExportedProgram:
    """Exported f(x (B, snippet_samples) fp32) -> (z (B, T, d_enc),
    c (B, T, d_ar)) with `model`'s weights baked in, traced on the device
    of its parameters.

    batch=None exports a symbolic batch: one artifact answers any batch
    size. An int pins it. params_dtype='bfloat16' bakes the weights in bf16
    (about half the file) at ~1e-2 relative feature error; compute stays in
    the model's dtype."""
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1 or None, got {batch}")
    m = _cast_params(_portable_model(model), params_dtype)
    x = torch.zeros((2 if batch is None else batch, int(snippet_samples)),
                    dtype=torch.float32, device=_device(m))
    dynamic = ({0: Dim("batch", min=1)},) if batch is None else None
    return torch.export.export(_Extractor(m, normalize), (x,),
                               dynamic_shapes=dynamic)


def export_streaming_step(model: CPCModel, *, chunk_latents: int,
                          n_streams: int = 1,
                          stats: Optional[Tuple[float, float]] = None
                          ) -> ExportedProgram:
    """Exported streaming step with the gar's state as an explicit carry:

      GRU:         f(h (num_layers, n_streams, d_ar), window) -> (z, c, h')
      transformer: f(k, v (num_layers, n_streams, max_len, H, Dh),
                   pos (n_streams,) int32, window) -> (z, c, k', v', pos')

    with z (n_streams, n, d_enc), c (n_streams, n, d_ar), n =
    chunk_latents, window (n_streams, W) fp32 and W = receptive_field +
    (chunk_latents - 1) * downsample.

    The contract of `StreamingExtractor`: the host slices W-sample windows
    that overlap by receptive_field - downsample samples (a hop of
    chunk_latents * downsample) and threads the state from zeros; the
    outputs, concatenated, equal the offline VALID forward. A transformer
    host also bounds each stream by max_len latents and may restart row b
    by zeroing pos[b]. `stats=(mean, std)` bakes (window - mean) / std."""
    cfg = model.config
    if chunk_latents < 1:
        raise ValueError(f"chunk_latents must be >= 1, got {chunk_latents}")
    if n_streams < 1:
        raise ValueError(f"n_streams must be >= 1, got {n_streams}")
    if cfg.ar.kind not in ("gru", "transformer"):
        raise ValueError(
            f"the streaming-step artifact supports the gru and transformer "
            f"gar kinds, got {cfg.ar.kind!r}")
    device = _device(model)
    m = portable_stream_model(cfg, device)
    m.load_state_dict(model.state_dict())
    m = _frozen(m)
    rf, down = receptive_field(cfg.encoder.kernels, cfg.encoder.strides)
    window = rf + (chunk_latents - 1) * down
    if stats is not None:
        m0, s0 = float(stats[0]), float(stats[1])
        if not (math.isfinite(m0) and math.isfinite(s0) and s0 > 0):
            raise ValueError(
                f"stats=(mean, std) needs a finite positive std, got "
                f"({m0}, {s0}) — the artifact would bake (win - mean)/std "
                "as NaN/inf forever")
        stats = (m0, s0)
    win = torch.zeros((n_streams, window), dtype=torch.float32,
                      device=device)
    ar = m.config.ar
    if ar.kind == "transformer":
        decoder = carry_decode_model(encoder_width(cfg.encoder), ar)
        decoder.load_state_dict(m.gar.state_dict())
        decoder.to(device).eval().requires_grad_(False)
        kv = torch.zeros((ar.num_layers, n_streams, ar.max_len,
                          ar.num_heads, ar.d_ar // ar.num_heads),
                         dtype=torch.float32, device=device)
        pos = torch.zeros((n_streams,), dtype=torch.int32, device=device)
        return torch.export.export(_TransformerStep(m, stats, decoder),
                                   (kv, kv.clone(), pos, win))
    h = torch.zeros((ar.num_layers, n_streams, ar.d_ar),
                    dtype=torch.float32, device=device)
    return torch.export.export(_GruStep(m, stats), (h, win))


def _aval(t) -> str:
    """'f32[b,2000]': dtype and shape as JAX prints an aval; a symbolic
    dimension is `b`."""
    dims = ",".join(str(d) if isinstance(d, int) else "b" for d in t.shape)
    return f"{_SHORT.get(t.dtype, str(t.dtype))}[{dims}]"


def avals(ep: ExportedProgram) -> Tuple[list, list]:
    """(inputs, outputs) of the program's user signature, as the fake
    tensors of its graph (shape and dtype; a symbolic batch as a SymInt)."""
    nodes = {n.name: n for n in ep.graph.nodes}
    sig = ep.graph_signature
    out = next(n for n in ep.graph.nodes if n.op == "output").args[0]
    users = set(sig.user_outputs)
    return ([nodes[name].meta["val"] for name in sig.user_inputs],
            [a.meta["val"] for a in out if a.name in users])


def _fn_name(ins: list) -> str:
    return {1: "extractor", 2: "gru_step", 4: "transformer_step"}[len(ins)]


def save_artifact(path: str, ep: ExportedProgram,
                  meta: Optional[dict] = None) -> dict:
    """Writes the program to `path` (`torch.export.save`) and a
    human-readable sidecar to `path`.json: format version, function,
    platforms, input and output shapes, the file's bytes, `"kernels":
    "plain"`, plus the caller's `meta` (checkpoint step, training config).
    Returns the sidecar."""
    torch.export.save(ep, path)
    ins, outs = avals(ep)
    sidecar = {
        "format_version": FORMAT_VERSION,
        "fn_name": _fn_name(ins),
        "platforms": list(PLATFORMS),
        "in_avals": [_aval(t) for t in ins],
        "out_avals": [_aval(t) for t in outs],
        "bytes": os.path.getsize(path),
        "kernels": "plain",
        **(meta or {}),
    }
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=1)
    return sidecar


def load_artifact(path: str, device=None) -> ExportedProgram:
    """The saved program, moved to `device` when one is given
    (`torch.export.passes.move_to_device_pass`: weights, constants and the
    devices written into the graph). Run it with `.module()(*args)`."""
    ep = torch.export.load(path)
    if device is not None:
        ep = move_to_device_pass(ep, torch.device(device))
    return ep
