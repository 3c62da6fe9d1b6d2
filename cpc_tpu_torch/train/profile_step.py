"""Where a training step's time goes on the GPU:

    python -m cpc_tpu_torch.train.profile_step [--config tpu_fast]
        [--set PATH=VAL ...] [--steps 5] [--table FILE]

Builds the step of `--config` (`tpu_fast`, `transformer_fast`, ...; with
the `--set` overrides, as the training CLI takes them: `--set
model.loss.negatives=all_steps` profiles the all-steps loss path, `--set
model.ar.attn_impl=flash16` the attention kernels) at full width with
random weights (seed 0) and one seeded int16 batch, as `chip_smoke.py`
phase 7 does, with the trainer's own backend settings. It prints the
card's name and power limit, then:

- the step time (median, min, max of 10, host clock with a CUDA sync)
  with the batch resident on the device and with it copied from the host
  each step through `to_device`, as the trainer does;
- CUDA-event times of the encoder forward, the gar forward, the loss
  forward and backward and the whole step; the optimizer is the step less
  the forward and backward;
- a `torch.profiler` trace of `--steps` steps: wall time, device kernel
  time and the device's busy share, and the device time per step of each
  stage (`stage_of`), largest first.

`--table FILE` writes the profiler's per-kernel table there.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict

import numpy as np
import torch

# (stage, substrings of a kernel's name), first match wins: the port's own
# kernels, then cuDNN's convolutions (whose implicit-GEMM kernels also say
# "gemm"), then cuBLAS (whose Hopper kernels are named nvjet_*)
STAGES = (
    # resident route (every preset), then the streamed route's kernels
    ("GRU forward kernel", ("gru_fwd_resident_kernel", "gru_scan_fwd_kernel")),
    ("GRU backward gates kernel (all steps at once)", ("gru_gates_kernel",)),
    ("GRU backward recurrence kernel",
     ("gru_bwd_resident_kernel", "gru_scan_bwd_kernel")),
    ("GRU dwh/dbh reduction kernels", ("gru_bwd_reduce", "gru_bwd_finish")),
    # the tensor-core route (bf16 models), then the SIMT route's kernels,
    # of the fused heads and of the same-step pair on materialized preds
    ("fused heads + InfoNCE forward kernel",
     ("heads_fwd_mma", "heads_nll_fwd")),
    ("fused heads + InfoNCE backward kernels",
     ("heads_bwd_mma", "heads_delta", "heads_dz", "heads_dp")),
    ("same-step InfoNCE forward kernel",
     ("same_step_fwd_mma", "same_step_fwd_kernel")),
    ("same-step InfoNCE backward kernels",
     ("same_step_bwd_mma", "same_step_delta", "same_step_dz",
      "same_step_dp")),
    # the wgmma route (bf16 models), then the SIMT route's kernels; dZ's
    # finishing kernel adds its row groups' partials
    ("all-steps InfoNCE forward kernel",
     ("allsteps_fwd_wgmma", "allsteps_fwd_kernel")),
    ("all-steps InfoNCE backward dP kernel",
     ("allsteps_dp_wgmma", "allsteps_dp_kernel")),
    ("all-steps InfoNCE backward dZ kernels",
     ("allsteps_dz_wgmma", "allsteps_dz_finish", "allsteps_dz_kernel")),
    ("flash attention forward kernel", ("flash_fwd",)),
    ("flash attention one-pass backward kernels (flash16)", ("flash_bwd",)),
    ("flash attention backward dQ kernel", ("flash_dq",)),
    ("flash attention backward dK/dV kernel", ("flash_dkv",)),
    ("conv pyramid forward kernels (encoder.use_pallas)", ("pyramid_",)),
    ("transformer (LayerNorm, MLP activation, softmax of the xla path)",
     ("layer_norm", "layernorm", "gammabeta", "gelu", "softmax")),
    # under encoder.use_pallas cuDNN still runs the recompute and the
    # backward of the chain
    ("conv encoder (cuDNN, with its layout transposes)",
     ("conv", "fprop", "dgrad", "wgrad", "nchw", "nhwc", "cudnn")),
    ("matmuls (cuBLAS): heads product, folds, gar projections and MLP",
     ("gemm", "cublas", "nvjet")),
)
OTHER = "the rest: optimizer, elementwise, casts, reductions"


def stage_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    for stage, keys in STAGES:
        if any(k in name for k in keys):
            return stage
    return OTHER


def _host_ms(fn: Callable[[], object], n: int = 10):
    """(median, min, max) ms of fn on the host clock, synced each side."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out), min(out), max(out)


def _event_ms(fn: Callable[[], object], n: int = 10) -> float:
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cpc_tpu_torch.train.profile_step")
    p.add_argument("--config", default="tpu_fast")
    p.add_argument("--set", action="append", default=[], metavar="PATH=VAL",
                   dest="overrides",
                   help="override a config field by dotted path; repeatable")
    p.add_argument("--steps", type=int, default=5,
                   help="steps under the profiler")
    p.add_argument("--table", default=None,
                   help="write the profiler's per-kernel table to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA GPU")

    from torch.profiler import ProfilerActivity, profile

    from cpc_tpu_torch.config import apply_overrides, presets
    from cpc_tpu_torch.data.loader import device_prepare, to_device
    from cpc_tpu_torch.ops import _build
    from cpc_tpu_torch.train.train_step import init_state, make_step_fns

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"gpu: {card}", flush=True)
    _build.load_library()
    cfg = presets.by_name(args.config)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    model = init_state(cfg, "cuda")
    steps = make_step_fns(cfg, model)
    B, S = cfg.data.batch_size, cfg.data.snippet_samples
    host = np.clip(np.random.default_rng(3).standard_normal((B, S)) * 3000,
                   -32768, 32767).astype(np.int16)
    dev = to_device(host, "cuda")
    for _ in range(3):  # warm-up
        steps.train_step(dev)

    fmt = "median {:.2f} ms (min {:.2f}, max {:.2f}) of 10"
    print(f"{args.config} {' '.join(args.overrides)} step, batch {B} x {S}, "
          f"on {card}:", flush=True)
    print("  device-resident batch: "
          + fmt.format(*_host_ms(lambda: steps.train_step(dev))))
    print("  batch from the host each step: " + fmt.format(
        *_host_ms(lambda: steps.train_step(to_device(host, "cuda")))))

    x = device_prepare(dev, cfg.data.normalize)
    with torch.no_grad():
        enc_ms = _event_ms(lambda: model.encoder(x))
        z = model.encoder(x)
        gar_ms = _event_ms(lambda: model.gar(z))

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        steps.loss_fn(model, dev)[0].backward()

    fb_ms = _event_ms(fwd_bwd)
    step_ms = _event_ms(lambda: steps.train_step(dev))
    print(f"CUDA events, medians of 10: encoder forward {enc_ms:.2f} ms, "
          f"gar forward ({cfg.model.ar.kind}) {gar_ms:.2f} ms, loss forward "
          f"+ backward {fb_ms:.2f} ms, step {step_ms:.2f} ms, optimizer "
          f"(step less forward + backward) {step_ms - fb_ms:.2f} ms",
          flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            steps.train_step(dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [k for k in prof.key_averages()
               if k.device_type == torch.autograd.DeviceType.CUDA]
    per_stage: Dict[str, float] = defaultdict(float)
    for k in kernels:
        per_stage[stage_of(k.key)] += k.self_device_time_total / 1e3
    device_ms = sum(per_stage.values())
    print(f"profile of {args.steps} steps: wall {wall_ms:.2f} ms, device "
          f"kernel time {device_ms:.2f} ms, busy "
          f"{device_ms / wall_ms:.3f}, idle {1 - device_ms / wall_ms:.3f}")
    for stage, ms in sorted(per_stage.items(), key=lambda kv: -kv[1]):
        print(f"  {ms / args.steps:8.3f} ms/step  {ms / device_ms:6.1%}  "
              f"{stage}")
    if args.table:
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=60,
                max_name_column_width=90))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
