"""Real-time feature server: raw PCM in, CPC feature frames out.

    python -m cpc_tpu_torch.serve --workdir RUNDIR [--emit c|z|zc] \
        [--in-format f32|i16] [--stats MEAN STD] [--device cuda]
    python -m cpc_tpu_torch.serve --artifact PATH [--emit ...] [--device ...]

Port of `cpc_tpu/serve.py`: a process that reads a raw mono PCM stream on
stdin and writes float32 feature frames to stdout, in constant memory. Two
backends behind one stream interface (`push`, `pending_samples`, `down`,
`rf`, `d_enc`, `d_ar`), one serve loop:

  * `--workdir RUNDIR` — `eval.streaming.StreamingExtractor` (GRU or
    transformer gar) over the workdir's weights (`eval.cli.load_weights`:
    the newest checkpoint, else jax_params.npz; a workdir with neither
    exits). Partial windows at chunk boundaries are handled latent-exactly
    by the extractor's residual buffer.
  * `--artifact PATH` — a streaming-step artifact (`python -m
    cpc_tpu_torch.eval --export-model PATH --export-streaming N`;
    `export.py`), loaded with `export.load_artifact`. The compute is the
    exported program; this module supplies only the host-side window
    slicing, from the program's input shapes and the encoder geometry in
    the `PATH.json` sidecar. It steps in fixed windows and drops up to one
    window's tail at EOF (counted in the summary), and a transformer
    artifact's stream stops at its positional table. It calls the program
    with TF32 off (`eval.streaming.fp32_exact`), as the live extractor
    pushes: the program's convs follow the process's cuDNN settings, and
    torch's default lets cuDNN take TF32.

The model runs on `--device` (default cuda; raises where there is no card).
Over every complete window the two backends agree: bit for bit on the CPU,
where both run the plain recurrence, and within the stream tolerances on
the card, where the live model runs the GRU kernel.

Wire protocol (the JAX server's):
  stdin:  raw mono PCM, little-endian, `--in-format f32` (default) or
          `i16` (scaled by 1/32768, the corpus wire format), read
          `--chunk-samples` samples at a time.
  stdout: consecutive float32-LE frames, one per latent step
          (`frame_stride_samples` input samples); each frame is d_ar
          values for `--emit c` (default), d_enc for `--emit z`,
          d_enc + d_ar for `--emit zc`. Frames flush after every chunk.
  stderr: one JSON header line at start (emit, frame_dim,
          frame_stride_samples, receptive_field_samples, d_enc, d_ar) and
          one JSON summary line at EOF (frames, dropped_tail_samples: the
          residual buffer; dropped_partial_bytes: a partial sample).
`--info` prints the header and exits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from cpc_tpu_torch.config import from_dict
from cpc_tpu_torch.eval.cli import cuda_or_raise, load_weights
from cpc_tpu_torch.eval.streaming import (StreamingExtractor, fp32_exact,
                                          receptive_field)
from cpc_tpu_torch.export import avals, load_artifact
from cpc_tpu_torch.models.cpc import CPCModel


def _read_chunks(stream, nbytes: int):
    while True:
        b = stream.read(nbytes)
        if not b:
            return
        yield b


def _to_f32(raw: bytes, in_format: str, carry: bytes) -> tuple:
    """Decode a byte chunk (plus any carried partial sample) to float32."""
    buf = carry + raw
    itemsize = 4 if in_format == "f32" else 2
    n = len(buf) // itemsize
    body, rest = buf[: n * itemsize], buf[n * itemsize:]
    if in_format == "f32":
        x = np.frombuffer(body, "<f4").astype(np.float32)
    else:
        x = np.frombuffer(body, "<i2").astype(np.float32) / 32768.0
    return x, rest


class _ArtifactStream:
    """Fixed-window streaming over a streaming-step artifact on `device`,
    with StreamingExtractor's interface (push, pending_samples, down, rf,
    d_enc, d_ar).

    GRU artifacts compute f(h, window (1, W)) -> (z, c, h'); transformer
    artifacts carry their KV cache, f(k, v, pos, window) -> (z, c, k', v',
    pos'). The signature is found from the program's input shapes; the
    state starts at zeros and stays on the device. The window geometry (W,
    the hop, latents a call) comes from those shapes and the sidecar
    config's encoder kernels and strides (`receptive_field`)."""

    def __init__(self, path: str, device):
        ep = load_artifact(path, device)
        ins = avals(ep)[0]
        shapes = [tuple(t.shape) for t in ins]
        if len(ins) == 2 and len(shapes[0]) == 3:
            self._is_tr = False          # f(h, window)
        elif len(ins) == 4 and len(shapes[0]) == 5:
            self._is_tr = True           # f(k, v, pos, window)
            self.max_latents = shapes[0][2]
            self._seen = 0
        else:
            raise SystemExit(
                f"{path} is not a streaming-step artifact (inputs "
                f"{shapes}); export one with --export-model PATH "
                "--export-streaming N_LATENTS")
        n_streams, self.window = shapes[-1]
        if n_streams != 1:
            raise SystemExit(
                f"the serve CLI feeds ONE stdin stream; this artifact was "
                f"exported with n_streams={n_streams} (use the batched "
                f"artifact from your own host code, or re-export with "
                f"--export-streams 1)")
        sidecar = path + ".json"
        try:
            with open(sidecar) as f:
                cfg = json.load(f)["config"]
        except (OSError, KeyError, ValueError) as e:  # incl. corrupt JSON
            raise SystemExit(
                f"cannot read encoder geometry: {sidecar} missing or "
                f"without a 'config' entry ({e}); re-export via "
                "`python -m cpc_tpu_torch.eval --export-model` (it writes "
                "the sidecar) or serve from --workdir instead")
        enc = cfg["model"]["encoder"]
        self.rf, self.down = receptive_field(enc["kernels"], enc["strides"])
        self.n_latents = (self.window - self.rf) // self.down + 1
        self.hop = self.n_latents * self.down
        self.d_enc = int(enc["d_enc"])
        self.d_ar = int(cfg["model"]["ar"]["d_ar"])
        self._fn = ep.module()
        self._device = torch.device(device)
        self._state = [torch.zeros(s, dtype=t.dtype, device=self._device)
                       for s, t in zip(shapes[:-1], ins)]
        self._buf = np.zeros(0, np.float32)

    def _step(self, win: np.ndarray):
        if self._is_tr and self._seen + self.n_latents > self.max_latents:
            # past the positional table the index is out of range (a
            # device-side assert on CUDA): stop first, where the live
            # --workdir path raises
            raise SystemExit(
                f"stream exceeds the transformer artifact's positional "
                f"table ({self.max_latents} latents); restart the server "
                f"per stream or re-export with a larger ar.max_len")
        with torch.no_grad(), fp32_exact():   # as StreamingExtractor.push
            z, c, *self._state = self._fn(
                *self._state, torch.from_numpy(win).to(self._device))
        if self._is_tr:
            self._seen += self.n_latents
        return z[0].cpu().numpy(), c[0].cpu().numpy()

    def push(self, x: np.ndarray):
        """(z (n, d_enc), c (n, d_ar)) for every COMPLETE window."""
        self._buf = np.concatenate([self._buf, x])
        zs, cs = [], []
        while self._buf.shape[0] >= self.window:
            z, c = self._step(self._buf[None, :self.window])
            zs.append(z)
            cs.append(c)
            self._buf = self._buf[self.hop:]
        if not zs:
            return (np.zeros((0, self.d_enc), np.float32),
                    np.zeros((0, self.d_ar), np.float32))
        return np.concatenate(zs), np.concatenate(cs)

    @property
    def pending_samples(self) -> int:
        return int(self._buf.shape[0])


def _live_stream(workdir: str, stats, device) -> StreamingExtractor:
    """StreamingExtractor over a workdir's weights on `device`."""
    cfg_path = os.path.join(workdir, "config.json")
    try:
        with open(cfg_path) as f:
            cfg = from_dict(json.load(f))
    except OSError as e:
        raise SystemExit(f"no persisted config at {cfg_path} ({e}); "
                         "serve needs the run's exact model geometry")
    model = CPCModel(cfg.model)
    if load_weights(model, workdir, cfg) is None:
        raise SystemExit(f"no checkpoint under {workdir}")
    if cfg.data.normalize and stats is None:
        # the run trained on per-snippet-normalized input a stream cannot
        # reproduce; raw samples silently degrade the features
        print(json.dumps({"warning": (
            "this run trained with per-snippet normalization; serving "
            "without --stats MEAN STD feeds RAW samples — pass "
            "corpus-level stats for a fixed input normalization")}),
            file=sys.stderr, flush=True)
    return StreamingExtractor(model.to(device), stats=stats)


def main(argv: Optional[list] = None, stdin=None, stdout=None,
         stderr=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cpc_tpu_torch.serve",
        description="stream raw PCM on stdin -> float32 CPC feature "
                    "frames on stdout (see module docstring)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", metavar="PATH",
                     help="exported streaming-step artifact "
                          "(--export-streaming; needs its PATH.json "
                          "sidecar for encoder geometry)")
    src.add_argument("--workdir", metavar="DIR",
                     help="serve the latest checkpoint of a training run "
                          "(live model; GRU or transformer gar)")
    p.add_argument("--emit", default="c", choices=["c", "z", "zc"],
                   help="frame contents: context c (default), latents z, "
                        "or z+c concatenated")
    p.add_argument("--in-format", default="f32", choices=["f32", "i16"],
                   help="stdin sample format (little-endian mono; i16 is "
                        "scaled by 1/32768, the corpus wire format)")
    p.add_argument("--stats", type=float, nargs=2, default=None,
                   metavar=("MEAN", "STD"),
                   help="--workdir only: fixed input normalization "
                        "(x-MEAN)/STD. Artifacts bake theirs at export")
    p.add_argument("--chunk-samples", type=int, default=16000,
                   help="stdin read granularity (latency/throughput "
                        "trade; frames flush after every chunk)")
    p.add_argument("--info", action="store_true",
                   help="print the stream geometry JSON and exit")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    if args.stats is not None and args.artifact:
        p.error("--stats applies to --workdir (artifacts bake "
                "normalization at export time — see --export-stats)")
    if args.chunk_samples < 1:
        p.error(f"--chunk-samples must be >= 1, got {args.chunk_samples}")
    device = cuda_or_raise(args.device)

    stdin = stdin if stdin is not None else sys.stdin.buffer
    stdout = stdout if stdout is not None else sys.stdout.buffer
    stderr = stderr if stderr is not None else sys.stderr

    if args.artifact:
        stream = _ArtifactStream(args.artifact, device)
    else:
        stream = _live_stream(args.workdir, args.stats, device)
    frame_dim = {"c": stream.d_ar, "z": stream.d_enc,
                 "zc": stream.d_enc + stream.d_ar}[args.emit]
    header = {"emit": args.emit, "frame_dim": frame_dim,
              "frame_stride_samples": stream.down,
              "receptive_field_samples": stream.rf,
              "d_enc": stream.d_enc, "d_ar": stream.d_ar}
    print(json.dumps(header), file=stderr, flush=True)
    if args.info:
        return 0

    itemsize = 4 if args.in_format == "f32" else 2
    carry = b""
    frames = 0
    for raw in _read_chunks(stdin, args.chunk_samples * itemsize):
        x, carry = _to_f32(raw, args.in_format, carry)
        if x.size == 0:
            continue
        z, c = stream.push(x)
        if z.shape[0]:
            out = {"c": c, "z": z,
                   "zc": np.concatenate([z, c], axis=1)}[args.emit]
            stdout.write(np.ascontiguousarray(out, np.float32).tobytes())
            stdout.flush()
            frames += z.shape[0]
    print(json.dumps({"frames": frames,
                      "dropped_tail_samples": stream.pending_samples,
                      "dropped_partial_bytes": len(carry)}),
          file=stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
