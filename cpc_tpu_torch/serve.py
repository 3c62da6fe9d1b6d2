"""Real-time feature server: raw PCM in, CPC feature frames out.

    python -m cpc_tpu_torch.serve --workdir RUNDIR [--emit c|z|zc] \
        [--in-format f32|i16] [--stats MEAN STD] [--device cuda]

Port of the `--workdir` backend of `cpc_tpu/serve.py`: a process that reads
a raw mono PCM stream on stdin and writes float32 feature frames to stdout,
in constant memory, through `eval.streaming.StreamingExtractor` (GRU or
transformer gar) over the workdir's weights (`eval.cli.load_weights`: the
newest checkpoint, else jax_params.npz; a workdir with neither exits). The
model runs on `--device` (default cuda; raises where there is no card).
`--artifact` (the exported StableHLO backend) waits for ROADMAP.md A9 and
raises.

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

from cpc_tpu_torch.config import from_dict
from cpc_tpu_torch.eval.cli import cuda_or_raise, load_weights
from cpc_tpu_torch.eval.streaming import StreamingExtractor
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


def _live_stream(workdir: str, stats, device) -> tuple:
    """(StreamingExtractor over a workdir's weights on `device`, the run's
    config)."""
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
    return StreamingExtractor(model.to(device), stats=stats), cfg


def main(argv: Optional[list] = None, stdin=None, stdout=None,
         stderr=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cpc_tpu_torch.serve",
        description="stream raw PCM on stdin -> float32 CPC feature "
                    "frames on stdout (see module docstring)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", metavar="PATH",
                     help="exported streaming-step artifact (not ported "
                          "yet: ROADMAP.md A9)")
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
                        "(x-MEAN)/STD")
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
                "normalization at export time)")
    if args.chunk_samples < 1:
        p.error(f"--chunk-samples must be >= 1, got {args.chunk_samples}")
    if args.artifact:
        raise NotImplementedError(
            "--artifact (the exported StableHLO streaming step) is not "
            "ported yet: ROADMAP.md A9; serve a training run with --workdir")
    device = cuda_or_raise(args.device)

    stdin = stdin if stdin is not None else sys.stdin.buffer
    stdout = stdout if stdout is not None else sys.stdout.buffer
    stderr = stderr if stderr is not None else sys.stderr

    ex, cfg = _live_stream(args.workdir, args.stats, device)
    d_enc, d_ar = cfg.model.encoder.d_enc, cfg.model.ar.d_ar
    frame_dim = {"c": d_ar, "z": d_enc, "zc": d_enc + d_ar}[args.emit]
    header = {"emit": args.emit, "frame_dim": frame_dim,
              "frame_stride_samples": ex.down,
              "receptive_field_samples": ex.rf,
              "d_enc": d_enc, "d_ar": d_ar}
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
        z, c = ex.push(x)
        if z.shape[0]:
            out = {"c": c, "z": z,
                   "zc": np.concatenate([z, c], axis=1)}[args.emit]
            stdout.write(np.ascontiguousarray(out, np.float32).tobytes())
            stdout.flush()
            frames += z.shape[0]
    print(json.dumps({"frames": frames,
                      "dropped_tail_samples": ex.pending_samples,
                      "dropped_partial_bytes": len(carry)}),
          file=stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
