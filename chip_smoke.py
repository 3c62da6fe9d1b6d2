#!/usr/bin/env python3
"""Drives the PyTorch port (cpc_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, in order; any failure exits non-zero:

1. device: a CUDA GPU is required; prints its name and power limit as
   nvidia-smi reports them;
2. build: compiles cpc_tpu_torch/csrc/*.cu with nvcc for sm_90a;
3. kernel vs plain: the CUDA `gru_scan` against `gru_scan_reference` on the
   same CUDA tensors, at the slice's shape (T, B, H) = (128, 64, 256) in
   bf16 and fp32 (the resident route: wh in the shared memory of a
   thread-block cluster; checked), at a ragged (7, 3, 40) (the streamed
   route), and at one more shape of each route ((5, 17, 256): a ragged last
   tile of a cluster; (3, 5, 512): wider than a cluster) and at the
   probes' extraction batch (128, 32, 256) bf16, each run twice for
   bit-identical results; then both times at the slice's shape in bf16
   (median of CUDA-event-timed runs) and µs per step, with torch.nn.GRU
   (cuDNN; it also does the input projection) as the library yardstick,
   the resident kernel at 16 rows a cluster, the streamed kernel at the
   same shape, and the exchange and cluster barrier alone (the serial
   floor);
4. the extraction slice: `extract_features` of a `tpu_fast` CPCModel (full
   width, random weights from a seed) over 4 batches of 64 windows of
   seeded synthetic audio; checks shapes, finiteness, the kernel's launch
   count, and c against the same model with the plain recurrence; prints
   the extraction throughput;
5. the training kernels against their plain versions on the same CUDA
   tensors: the GRU backward at the slice's (128, 64, 256) and at
   (7, 3, 40), the fused heads + InfoNCE forward and backward at the
   slice's (T, B, C, K, D) = (128, 64, 64, 12, 512) and at (20, 3, 6, 3, 40)
   with shift 3, each in bf16 and fp32, and in bf16 at transformer_fast's
   long context (1024, 16, 16, 12, 512) and at a ragged (16, 24, 70, 4, 64)
   with shift 5 (each case's route, tensor cores for bf16 and SIMT for
   fp32, checked against `heads_route`; the heads backward held relative to
   the largest entry of plain, and on its share of entries whose bf16
   rounding differs from plain's; the heads backward and the GRU backward,
   also at phase 3's two extra shapes, twice for bit-identical results);
   then kernel and plain times at the slice's shape in bf16, with
   torch.nn.GRU's backward (cuDNN) beside the GRU backward as a yardstick
   only, and the GRU backward's three stages apart (gates of all steps,
   reversed recurrence, dwh/dbh reduction; from torch.profiler); and the
   heads kernels at both full-width shapes over a CUDA-graph replay,
   beside the SIMT kernels at the same inputs (the route forced), the plain
   versions and the bound;
6. the training slice through its entry point:
   `cpc_tpu_torch.train.cli.main` trains `tpu_fast` at full width on the
   synthetic corpus for 10 steps; checks that metrics.jsonl is finite, that
   each of the four kernels launched once per step, and that a checkpoint
   was written;
7. one full-width step on a seeded batch through the kernels against the
   same step composed here from the model's modules and the plain
   versions: loss, per-k accuracy, grad_norm and the grads of wh and of the
   heads' weight; then the steady training rate;
8. the kernels of the other two loss paths against their plain versions on
   the same CUDA tensors: the same-step InfoNCE on materialized predictions
   and the all-steps InfoNCE, forward and backward, at tpu_fast's
   (B, T, C, K, D) = (64, 128, 64, 12, 512) (all-steps: 89 088 rows against
   8 192 candidates) and at (3, 20, 6, 3, 40) with shift 3, each in bf16
   and fp32, and in bf16 at transformer_fast's long context
   (16, 1024, 16, 12, 512) (194 304 rows against 16 384) and at a ragged
   (5, 37, 9, 4, 72) with shift 2 (R, N and D no multiple of a tile): nll,
   lse, correct, dpreds, dz, the backward twice for bit-identical results,
   each case's same-step route ("mma" for bf16, "simt" for fp32) against
   `same_step_route` and all-steps route (wgmma for bf16, SIMT for fp32)
   against `allsteps_route`; the bf16 same-step dpreds and dz also on their
   shares of bf16-rounding flips against plain, a check held once against
   the same-step backward built with delta in two bf16 terms, which must
   fail it; then kernel and plain times in bf16 at both full-width shapes,
   the same-step kernels over a CUDA-graph replay beside their SIMT kernels
   on the same inputs (the route forced), the all-steps kernels with their
   achieved TFLOP/s and, as a yardstick of another function, the score
   product alone on cuBLAS;
9. those two paths through the entry point: `cpc_tpu_torch.train.cli.main`
   trains `tpu_fast` at full width for 10 steps with
   `--set model.loss.negatives=all_steps`, then with
   `--set model.loss.fuse_heads=false`; metrics finite, the path's kernels
   launched once per step, the other loss kernels not at all, a checkpoint
   written;
10. one full-width step of each of the two paths through the kernels
   against the same step composed from the plain versions: loss, per-k
   accuracy, grad_norm, the grads of the heads' weight and of the last
   encoder layer; then the steady step time and audio-s/s of each path;
11. the causal flash-attention kernels against their plain versions on the
   same CUDA tensors, at transformer_fast's (B, T, H, Dh) = (64, 128, 8, 32),
   at a long context (16, 1024, 8, 32) and at a ragged (2, 200, 3, 16), each
   as bf16 'flash16' (tensor cores), bf16 'flash' and fp32 'flash' (SIMT):
   o and lse of the forward; dq, dk, dv of `flash_attention_backward` on the
   route the shape takes (under 'flash16' the one-pass kernel, head-resident
   or split, and then on the other of the two as well; else the pair) and of
   `flash_attention_dq` and `flash_attention_dkv` (the pair) directly; every
   backward twice for bit-identical results; then kernel and plain times at
   the first two shapes in bf16 'flash16' (the kernels' from the replay of a
   CUDA graph, since one call runs for microseconds), with
   `scaled_dot_product_attention(is_causal=True)`, forward and backward, as
   the library yardstick, an empty kernel at the forward's and at the
   one-pass backward's grid, block and shared memory over the same replay
   as the launch floor, the forward that the tiled one replaced, and the
   one-pass backward on its other route; and, as the `flash` route's
   yardstick of the same function (fp32 P), the same SDPA call on fp32
   copies of q, k and v with TF32 off, forward and backward, with the
   kernels it ran;
12. the transformer slice through its entry points:
   `cpc_tpu_torch.train.cli.main` trains `transformer_fast` at full width
   for 10 steps with `--set model.ar.attn_impl=flash16`, then `=flash`,
   then the default `xla`: metrics finite, the forward kernel and, under
   `flash16`, the one-pass backward kernel (under `flash` the dQ and the
   dK/dV kernel) launched num_layers = 2 times per step and the others
   never (none under `xla`), the fused heads kernels once per step, the GRU
   kernels never, a checkpoint written; then
   5 steps at the long context (`--snippet-samples 163840 --batch-size 16`,
   T = 1 024, on a corpus of 12 s files written here, since the CLI's own
   synthetic files hold 4 s); then `extract_features` of the `flash16`
   model over 4 batches of 64 windows: shapes, finiteness, launches, c
   against the same model on the plain attention, and the rate;
13. one full-width transformer_fast step through the kernels against the
   same step composed from the plain versions, `flash16` and `flash`: loss,
   per-k accuracy, grad_norm, the grads of an attention query weight and of
   in_proj; then the steady step time and audio-s/s of `xla`, `flash` and
   `flash16`;
14. the conv pyramid forward against its plain version on the same CUDA
   tensors: tpu_fast's 5 layers at (B, S) = (64, 20 480) in bf16 and fp32,
   (16, 163 840) in bf16, (2, 20 000) in bf16 (no length fits a tile), and
   (1, 20) in bf16 (layers 3-5 read phases with no rows), and a narrow
   3-layer pyramid at (3, 3 205) in bf16 and fp32; each case's route against
   `pyramid_route` ("wgmma" for bf16, "simt" for fp32), twice for
   bit-identical results, the first and last two latents held on their own
   (SAME padding); then, at both full-width shapes in bf16, the forward,
   each launch apart, the weights' repack apart, plain, the bound and the
   F.conv1d chain on cuDNN as the yardstick; fp32 at tpu_fast;
15. `encoder.use_pallas=true` through `extract_features` (the forward once
   a batch, z against the cuDNN chain) and 10 CLI steps;
16. one `use_pallas` step through the kernels against the plain step;
17. the scalogram front end of `scalogram_fast` on the card: `scalogram`
   at full width, (64, 20 480) fp32 -> (64, 128, 128), for the `log`,
   `mel` and `cqt` scales on seeded white noise, each against the same
   function in float64 on the CPU, with its time; then, in bf16 at full
   width, the times of the front end, the Conv2d stack, `proj`, the
   encoder forward and the encoder forward + backward, with the stack's
   and proj's forward FLOPs and achieved TFLOP/s (a yardstick);
18. the scalogram slice through its entry points:
   `cpc_tpu_torch.train.cli.main` trains `scalogram_fast` at full width for
   10 steps on `--data synthetic-music` (metrics finite, a checkpoint, the
   GRU and fused heads kernels once a step and the other nine never); then
   `cpc_tpu_torch.eval.cli.main --extract` on a WAV written into that
   workdir: the checkpoint's step, the GRU kernel once a batch, shapes,
   finiteness, c against the same trained model on the plain recurrence,
   and the extraction rate;
19. one full-width `scalogram_fast` step through the kernels against the
   plain step: loss, per-k accuracy, grad_norm and the grads of the first
   Conv2d and of `proj`; then its steady step time and audio-s/s;
20. the probes on the card: `tpu_fast` trained 10 steps through the
   training CLI into a workdir, then `cpc_tpu_torch.eval.cli.main
   --battery` twice and `--probe both` on that workdir and its synthetic
   corpus: the row's keys (the JAX battery's), accuracies finite in [0, 1],
   the GRU kernel launched once a batch of the extraction, the same row
   twice; then the extraction's rate, the fit's time (400 Adam steps at the
   speaker probe's (N, 256) and the phone probe's (N*T, 512)), and the
   battery's wall time beside the sum of its extraction and 17 fits;
21. the streaming shapes of `gru_scan` (fp32, (T, B, H) = (1, 1, 256),
   (3, 1, 256), (100, 1, 256), (6, 8, 256), (100, 8, 256), a nonzero h0)
   against its plain version on the resident route, twice for
   bit-identical results, with their times; then `StreamingExtractor` on
   full-width `tpu_fast` (GRU) and `transformer_fast` models from seed 0
   under torch's default TF32 settings: 10 s of seeded audio in chunks of
   16 000, 2 560 and 1 001 samples, z and c against the portable model's
   offline VALID forward, the GRU kernel once a push that emits; 8
   lockstep streams with one reset_stream; ms a push and the real-time
   factor at 1 and 8 streams, and `decode_step`'s ms a latent;
22. the feature server through its entry point: `cpc_tpu_torch.serve.main
   --workdir` on phase 20's workdir with i16 stdin and `--emit zc`: the
   header's geometry, the frame count and summary, the frames bit for bit
   against a StreamingExtractor fed the same chunks; the serve loop's rate
   (header to summary) and the start-up (the load) apart.

It prints a JSON line of the kernels it checked, each with its launches on
its main path, its error against its plain version, its time, its plain
version's time, the least time the card could take (`bound_ms`: the larger
of the bytes it must move over 3.35 TB/s and its operations over the peak
rate of its input type, from this run's tensors) and, where one PyTorch
call computes the same function, that call's time (`library_ms`); and, last,
one JSON object naming the device.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from cpc_tpu_torch import CPCModel, extract_features, presets, serve
from cpc_tpu_torch.config import apply_overrides, from_dict
from cpc_tpu_torch.data.dataset import ProbeDataset
from cpc_tpu_torch.data.loader import device_prepare
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.data.wavio import decode_mono, write_wav
from cpc_tpu_torch.eval import cli as eval_cli
from cpc_tpu_torch.eval import probes
from cpc_tpu_torch.eval.cli import load_weights
from cpc_tpu_torch.eval.streaming import (StreamingExtractor, fp32_exact,
                                          portable_stream_model)
from cpc_tpu_torch.models.transformer import carry_decode_model, decode_carry
from cpc_tpu_torch.ops import (_build, attention_cuda, gru_cuda, infonce_cuda,
                               infonce_fused)
from cpc_tpu_torch.ops.attention_cuda import (
    _FlashPlain, attention_route, flash_attention_backward,
    flash_attention_backward_reference, flash_attention_dkv,
    flash_attention_dkv_reference, flash_attention_dq,
    flash_attention_dq_reference, flash_attention_forward,
    flash_attention_forward_reference, launch_floor, launch_shape, row_dot)
from cpc_tpu_torch.ops.conv_cuda import (_ConvPyramidPlain, conv_chain,
                                         conv_pyramid_forward,
                                         conv_pyramid_reference, pack_weights,
                                         pyramid_launches, pyramid_route)
from cpc_tpu_torch.ops.dsp import prepare_waveform
from cpc_tpu_torch.ops.gru_cuda import (_GruScanPlain,
                                        cluster_exchange_probe, gru_route,
                                        gru_scan, gru_scan_backward,
                                        gru_scan_backward_reference,
                                        gru_scan_reference)
from cpc_tpu_torch.ops.infonce_allsteps_cuda import (
    _AllStepsNllPlain, allsteps_nll_backward, allsteps_route,
    allsteps_nll_backward_reference, allsteps_nll_forward,
    allsteps_nll_reference, reduce_allsteps_nll)
from cpc_tpu_torch.ops.infonce_cuda import (_SameStepNllPlain,
                                            reduce_same_step_nll,
                                            same_step_nll_backward,
                                            same_step_nll_backward_reference,
                                            same_step_nll_forward,
                                            same_step_nll_reference,
                                            same_step_route)
from cpc_tpu_torch.ops.infonce_fused import (_HeadsNllPlain,
                                             heads_nll_backward,
                                             heads_nll_backward_reference,
                                             heads_nll_forward,
                                             heads_nll_reference,
                                             heads_route, reduce_heads_nll)
from cpc_tpu_torch.ops.scalogram import scalogram
from cpc_tpu_torch.train import cli as train_cli
from cpc_tpu_torch.train.checkpoint import CheckpointManager
from cpc_tpu_torch.train.train_step import (global_norm, init_state,
                                            make_step_fns)

TOL = {torch.float32: 1e-4,   # fp32 with TF32 off: summation order only
       torch.bfloat16: 2e-2}  # bf16 rounding of h and wh over 128 steps
SLICE_SHAPE = (128, 64, 256)  # (T, B, H) of tpu_fast
# the probes' extraction (phase 20) runs tpu_fast's bf16 GRU on batches of 32
PROBE_SHAPE = (128, 32, 256)
CASES = [(SLICE_SHAPE, torch.bfloat16), (SLICE_SHAPE, torch.float32),
         ((7, 3, 40), torch.float32), ((7, 3, 40), torch.bfloat16),
         (PROBE_SHAPE, torch.bfloat16)]
# one more shape of each route: a ragged last tile of a cluster's rows, and
# a width beyond a cluster (its slice of wh does not fit a block)
ROUTE_CASES = [((5, 17, 256), torch.bfloat16), ((5, 17, 256), torch.float32),
               ((3, 5, 512), torch.bfloat16), ((3, 5, 512), torch.float32)]
ROUTES = {(128, 64, 256): "resident", (5, 17, 256): "resident",
          PROBE_SHAPE: "resident",
          (7, 3, 40): "streamed", (3, 5, 512): "streamed"}


def gru_inputs(T, B, H, dtype, seed):
    """Seeded xproj, wh, bh and a nonzero h0 in (-1, 1), on the GPU."""
    rng = np.random.default_rng(seed)
    xproj = rng.standard_normal((T, B, 3 * H)) * 0.5
    wh = rng.standard_normal((H, 3 * H)) / np.sqrt(H)
    bh = rng.standard_normal(3 * H) * 0.1
    h0 = rng.uniform(-0.9, 0.9, (B, H))

    def dev(a, dt):
        return torch.from_numpy(a).to("cuda", dt).contiguous()
    return (dev(xproj, dtype), dev(wh, dtype), dev(bh, torch.float32),
            dev(h0, torch.float32))


def cuda_ms(fn, reps=20, warmup=3, inner=1, graph=False):
    """Median over `reps` runs of fn's CUDA-event time, in ms; each run is
    `inner` calls between one pair of events. With `graph` the `inner` calls
    are captured once into a CUDA graph and each run replays it: a call of a
    few microseconds, which the host cannot enqueue as fast as the card runs
    it, is then timed without the host's gaps."""
    if graph:
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(warmup):
                fn()
            captured = torch.cuda.CUDAGraph()
            with torch.cuda.graph(captured, stream=stream):
                for _ in range(inner):
                    fn()
        torch.cuda.current_stream().wait_stream(stream)
        run = captured.replay
    else:
        def run():
            for _ in range(inner):
                fn()
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device memory, and dense operations by input type (bf16 on the tensor
# cores, fp32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def bound(tensors, flops: float, dtype=torch.bfloat16) -> dict:
    """The least time the card could take: `tensors` (every input and
    output, once each) over the memory rate, or `flops` over the peak rate
    of `dtype`, whichever is larger."""
    by_bytes = sum(t.numel() * t.element_size()
                   for t in tensors) / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


# ---------------------------------------------------------------- phase 3
class forced:
    """Sets a constant of `gru_cuda` (or of `module`) for the time of a
    `with` block: the other rows a cluster, or no width on the resident
    route (so that the slice's shape runs the streamed kernels), or the
    attention kernels' other route, for a time beside the one the port
    runs."""

    def __init__(self, name, value, module=gru_cuda):
        self.name, self.value, self.module = name, value, module

    def __enter__(self):
        self.kept = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.kept)


def phase3_gru(card: str) -> dict:
    """`gru_scan` against its plain version on both routes, then its times;
    returns {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}."""
    for dtype in TOL:
        T, B, H = SLICE_SHAPE
        check(gru_route(B, H, dtype) == "resident",
              f"{SLICE_SHAPE} {dtype} takes the {gru_route(B, H, dtype)} "
              f"route")
    max_err = 0.0
    with torch.inference_mode():
        for n, ((T, B, H), dtype) in enumerate(CASES + ROUTE_CASES):
            route = gru_route(B, H, dtype)
            check(route == ROUTES[(T, B, H)], f"{(T, B, H)} takes {route}")
            args = gru_inputs(T, B, H, dtype, seed=n)
            out = gru_scan(*args)
            again = gru_scan(*args)
            ref = gru_scan_reference(*args)
            torch.cuda.synchronize()
            check(out.dtype == ref.dtype == dtype
                  and tuple(out.shape) == (T, B, H), f"{out.shape} {out.dtype}")
            check(bool(torch.isfinite(out.float()).all()), "non-finite hs")
            check(torch.equal(out, again),
                  f"gru_scan {(T, B, H)} differs between two runs")
            err = (out.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            print(f"gru_scan vs plain {(T, B, H)} {str(dtype)[6:]} ({route} "
                  f"route): max abs err {err:.3e} (tol {TOL[dtype]:.0e}); two "
                  f"runs bit-identical", flush=True)
            check(err <= TOL[dtype], f"gru_scan error {err} > {TOL[dtype]}")

        T, B, H = SLICE_SHAPE
        args = gru_inputs(T, B, H, torch.bfloat16, seed=0)
        cudnn, x, h0 = cudnn_gru(T, B, H)
        gru_fwd = {"max_abs_err": max_err,
                   "ms": cuda_ms(lambda: gru_scan(*args)),
                   "plain_ms": cuda_ms(lambda: gru_scan_reference(*args)),
                   "library_ms": cuda_ms(lambda: cudnn(x, h0)),
                   **bound([*args, gru_scan(*args)], 2 * T * B * H * 3 * H)}
        other_rows = 24 - gru_cuda._TILE_ROWS  # 16 beside 8
        with forced("_TILE_ROWS", other_rows):
            rows_ms = cuda_ms(lambda: gru_scan(*args))
        with forced("_RESIDENT_HIDDEN", ()):
            streamed_ms = cuda_ms(lambda: gru_scan(*args))
        probe_steps = 10 * T  # long enough to time without a CUDA graph
        floor_ms = cuda_ms(lambda: cluster_exchange_probe(
            probe_steps, H, "cuda")) * T / probe_steps
        fp32 = gru_inputs(T, B, H, torch.float32, seed=1)
        fp32_ms = cuda_ms(lambda: gru_scan(*fp32))
        probe = gru_inputs(*PROBE_SHAPE, torch.bfloat16, seed=2)
        probe_ms = cuda_ms(lambda: gru_scan(*probe))
        probe_plain_ms = cuda_ms(lambda: gru_scan_reference(*probe), reps=5)
        cudnn, px, ph0 = cudnn_gru(*PROBE_SHAPE)
        probe_lib_ms = cuda_ms(lambda: cudnn(px, ph0))
        Tp, Bp, Hp = PROBE_SHAPE
        probe_bnd = bound([*probe, gru_scan(*probe)],
                          2 * Tp * Bp * Hp * 3 * Hp)
    print(f"time {SLICE_SHAPE} bf16 on {card}: kernel {gru_fwd['ms']:.4f} "
          f"ms = {gru_fwd['ms'] / T * 1e3:.3f} us a step "
          f"({gru_cuda._TILE_ROWS} rows a cluster; {other_rows} rows "
          f"{rows_ms:.4f} ms; fp32 {fp32_ms:.4f} ms), plain "
          f"{gru_fwd['plain_ms']:.4f} ms, bound {gru_fwd['bound_ms']:.4f} ms "
          f"by {gru_fwd['bound_by']}, torch.nn.GRU (cuDNN, yardstick only) "
          f"{gru_fwd['library_ms']:.4f} ms; the streamed kernel at this shape "
          f"{streamed_ms:.4f} ms; the exchange and cluster barrier of {T} "
          f"steps alone (the serial floor) {floor_ms:.4f} ms = "
          f"{floor_ms / T * 1e3:.3f} us a step", flush=True)
    print(f"time {PROBE_SHAPE} bf16 (the probes' batch) on {card}: kernel "
          f"{probe_ms:.4f} ms, plain {probe_plain_ms:.4f} ms, bound "
          f"{probe_bnd['bound_ms']:.6f} ms by {probe_bnd['bound_by']}, "
          f"torch.nn.GRU (cuDNN, yardstick only) {probe_lib_ms:.4f} ms",
          flush=True)
    return gru_fwd


# ---------------------------------------------------------------- phase 5
# Tolerances, relative to max(1, max |plain|) of each output: fp32 differs
# by summation order only; bf16 outputs by at most about one rounding of
# the output (2**-8 relative) where an fp32 sum lands near a rounding edge.
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
NLL_TOL = 1e-4        # nll and lse, fp32 from exact products, any wire dtype
MISMATCH_TOL = 1e-4   # share of rows whose argmax may differ: near-ties
GRU_BWD_CASES = [(SLICE_SHAPE, torch.bfloat16), (SLICE_SHAPE, torch.float32),
                 ((7, 3, 40), torch.bfloat16), ((7, 3, 40), torch.float32)]
HEADS_SLICE = (128, 64, 64, 12, 512, 0)  # T, B, C, K, D, shift of tpu_fast
# transformer_fast at its long context: T = 1 024, batch 16, C = B
HEADS_LONG = (1024, 16, 16, 12, 512, 0)
HEADS_CASES = [(HEADS_SLICE, torch.bfloat16), (HEADS_SLICE, torch.float32),
               ((20, 3, 6, 3, 40, 3), torch.bfloat16),
               ((20, 3, 6, 3, 40, 3), torch.float32),
               (HEADS_LONG, torch.bfloat16),
               # C > 64 and no multiple of 8: a ragged second column tile
               ((16, 24, 70, 4, 64, 5), torch.bfloat16)]
# the route each wire dtype takes at these shapes (D a multiple of 8)
HEADS_ROUTES = {torch.bfloat16: "mma", torch.float32: "simt"}
# The heads backward's dz and dp are held to REL_TOL relative to max |plain|
# (not max(1, .): the cotangent is drawn at 1/(T*B), so dp and dz lie far
# below 1), and on the share of entries whose bf16 rounding differs from
# plain's (dp is bf16; dz is rounded to bf16 on its way into the encoder).
# Readings at tpu_fast, H100 (PERF.md): delta in 3 bf16 terms, as built, dz
# 1.7e-6 of max, flips dz 3.6e-4, dp 1.2e-4; the SIMT kernels 1.7e-6,
# 3.4e-4, 0; delta in 2 terms 4.9e-6, 2.1e-3, 8.3e-4; delta rounded once to
# bf16 dz 2.4e-3 of max. Each limit lies between the first two and the last
# two, so a lower-precision or zeroed output fails.
HEADS_FLIP_TOL = {"dz": 1e-3, "dp": 3e-4}
# a share is held over at least this many entries (else it is a few flips)
FLIP_MIN_ENTRIES = 65536


def rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


def rel_to_max(got, want) -> float:
    """max |got - want| / max |want|."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def bf16_flips(got, want) -> float:
    """The share of entries whose bf16 rounding differs."""
    return (got.bfloat16() != want.bfloat16()).float().mean().item()


def heads_inputs(T, B, C, K, D, dtype, seed):
    """Seeded p (T, B, K*D), z_tm (T, C, D) and a cotangent (T, K*B)."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((T, B, K * D)) / np.sqrt(D)
    z = rng.standard_normal((T, C, D))
    g = rng.standard_normal((T, K * B)) / (T * B)

    def dev(a, dt):
        return torch.from_numpy(a).to("cuda", dt).contiguous()
    return dev(p, dtype), dev(z, dtype), dev(g, torch.float32)


def heads_checks(errs: dict) -> None:
    """The fused heads kernels against their plain versions at
    `HEADS_CASES`; raises on the first disagreement and keeps the largest
    absolute errors in `errs`."""
    for n, ((T, B, C, K, D, shift), dtype) in enumerate(HEADS_CASES):
        route = heads_route(T, B, C, K, D, dtype)
        check(route == HEADS_ROUTES[dtype],
              f"heads {(T, B, C, K, D)} {dtype} takes {route}")
        p, z, g = heads_inputs(T, B, C, K, D, dtype, seed=30 + n)
        nll, cor, lse = heads_nll_forward(p, z, shift, K)
        r_nll, r_cor, r_lse = heads_nll_reference(p, z, shift, K)
        torch.cuda.synchronize()
        err = max((nll - r_nll).abs().max().item(),
                  (lse - r_lse).abs().max().item())
        miss = (cor != r_cor).float().mean().item()
        errs["heads_nll_forward"] = max(errs["heads_nll_forward"], err)
        print(f"heads_nll_forward vs plain {(T, B, C, K, D)} shift "
              f"{shift} {str(dtype)[6:]} ({route} route): nll/lse max "
              f"abs err {err:.3e} "
              f"(tol {NLL_TOL:.0e}), argmax mismatch share {miss:.2e} "
              f"(tol {MISMATCH_TOL:.0e})", flush=True)
        check(err <= NLL_TOL and miss <= MISMATCH_TOL,
              f"heads fwd error {err}, mismatch {miss}")
        check(bool(torch.isfinite(nll).all()), "heads fwd non-finite")
        dz, dp = heads_nll_backward(g, r_lse, p, z, shift, K)
        again = heads_nll_backward(g, r_lse, p, z, shift, K)
        r_dz, r_dp = heads_nll_backward_reference(g, r_lse, p, z, shift, K)
        torch.cuda.synchronize()
        for name, a, a2, b, tol in (
                ("dz", dz, again[0], r_dz, REL_TOL[torch.float32]),
                ("dp", dp, again[1], r_dp, REL_TOL[dtype])):
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"heads bwd {name}: {a.dtype} {tuple(a.shape)}")
            check(torch.equal(a, a2), f"heads bwd {(T, B, C, K, D)} "
                  f"{name} differs between two runs")
            err = rel_to_max(a, b)
            flips = bf16_flips(a, b)
            held = a.numel() >= FLIP_MIN_ENTRIES
            flip_tol = HEADS_FLIP_TOL[name]
            abs_err = (a.float() - b.float()).abs().max().item()
            errs["heads_nll_backward"] = max(errs["heads_nll_backward"],
                                             abs_err)
            print(f"heads_nll_backward vs plain {(T, B, C, K, D)} "
                  f"{str(dtype)[6:]} ({route} route) {name}: max abs err "
                  f"{abs_err:.3e}, relative to max |plain| {err:.3e} "
                  f"(tol {tol:.0e}), bf16 flips {flips:.3e} "
                  + (f"(tol {flip_tol:.0e})" if held else
                     f"(not held: {a.numel()} entries)")
                  + "; two runs bit-identical", flush=True)
            check(err <= tol, f"heads bwd {name} error {err} > {tol}")
            check(not held or flips <= flip_tol,
                  f"heads bwd {name} bf16 flips {flips} > {flip_tol}")


def phase5_kernels(card: str) -> dict:
    """Backward GRU and fused heads kernels against their plain versions;
    returns {name: {max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by}}."""
    errs = {"gru_scan_backward": 0.0, "heads_nll_forward": 0.0,
            "heads_nll_backward": 0.0}
    with torch.inference_mode():
        for n, ((T, B, H), dtype) in enumerate(GRU_BWD_CASES + ROUTE_CASES):
            route = gru_route(B, H, dtype)
            check(route == ROUTES[(T, B, H)], f"{(T, B, H)} takes {route}")
            xp, wh, bh, h0 = gru_inputs(T, B, H, dtype, seed=10 + n)
            g = torch.from_numpy(np.random.default_rng(20 + n).standard_normal(
                (T, B, H))).to("cuda", dtype)
            hs = gru_scan_reference(xp, wh, bh, h0)
            got = gru_scan_backward(xp, wh, bh, h0, hs, g)
            again = gru_scan_backward(xp, wh, bh, h0, hs, g)
            want = gru_scan_backward_reference(xp, wh, bh, h0, hs, g)
            torch.cuda.synchronize()
            for name, a, a2, b in zip(("dxproj", "dwh", "dbh", "dh0"), got,
                                      again, want):
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"gru bwd {name}: {a.dtype} {tuple(a.shape)}")
                check(bool(torch.isfinite(a.float()).all()),
                      f"gru bwd {name} non-finite")
                check(torch.equal(a, a2),
                      f"gru bwd {(T, B, H)} {name} differs between two runs")
                err = rel_err(a, b)
                tol = REL_TOL[torch.float32 if b.dtype == torch.float32
                              else dtype]
                abs_err = (a.float() - b.float()).abs().max().item()
                errs["gru_scan_backward"] = max(errs["gru_scan_backward"],
                                                abs_err)
                print(f"gru_scan_backward vs plain {(T, B, H)} "
                      f"{str(dtype)[6:]} ({route} route) {name}: max abs err "
                      f"{abs_err:.3e}, relative to max(1, max |plain|) "
                      f"{err:.3e} (tol {tol:.0e}); two runs bit-identical",
                      flush=True)
                check(err <= tol, f"gru bwd {name} error {err} > {tol}")

        heads_checks(errs)

        T, B, H = SLICE_SHAPE
        xp, wh, bh, h0 = gru_inputs(T, B, H, torch.bfloat16, seed=10)
        g = torch.randn((T, B, H), device="cuda").to(torch.bfloat16)
        hs = gru_scan_reference(xp, wh, bh, h0)
        args = (xp, wh, bh, h0, hs, g)
        outs = gru_scan_backward(*args)
        out = {"gru_scan_backward": {
            "ms": cuda_ms(lambda: gru_scan_backward(*args)),
            "plain_ms": cuda_ms(lambda: gru_scan_backward_reference(*args),
                                reps=5),
            # gate recompute, dh = dhp wh^T and dwh = h^T dhp
            **bound([*args, *outs], 3 * 2 * T * B * H * 3 * H)}}
        other_rows = 24 - gru_cuda._TILE_ROWS  # 16 beside 8
        with forced("_TILE_ROWS", other_rows):
            rows_ms = cuda_ms(lambda: gru_scan_backward(*args))
        with forced("_RESIDENT_HIDDEN", ()):
            streamed_ms = cuda_ms(lambda: gru_scan_backward(*args), reps=5)
        fp32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
        fp32_ms = cuda_ms(lambda: gru_scan_backward(*fp32))
        heads_times = {shape: heads_times_ms(shape)
                       for shape in (HEADS_SLICE, HEADS_LONG)}
        for name in HEADS_KERNELS:
            out[name] = dict(heads_times[HEADS_SLICE][name], library_ms=None)
    stages = gru_backward_stages_ms(args)
    m = out["gru_scan_backward"]
    print(f"time gru_scan_backward {SLICE_SHAPE} bf16 on {card}, its three "
          f"stages from torch.profiler: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items())
          + f"; the reversed recurrence "
          f"{stages['recurrence'] / SLICE_SHAPE[0] * 1e3:.3f} us a step; the "
          f"whole call {m['ms']:.4f} ms = "
          f"{m['ms'] / SLICE_SHAPE[0] * 1e3:.3f} us a step ({gru_cuda._TILE_ROWS} rows a "
          f"cluster; {other_rows} rows {rows_ms:.4f} ms; fp32 {fp32_ms:.4f} "
          f"ms); the streamed kernels at this shape {streamed_ms:.4f} ms",
          flush=True)
    for (T, B, C, K, D, _), times in heads_times.items():
        for name, m in times.items():
            print(f"time {name} {(T, B, C, K, D)} bf16 on {card}: "
                  f"tensor-core kernel {m['ms']:.4f} ms [SIMT kernels of the "
                  f"same call {m['simt_ms']:.4f} ms], "
                  f"plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} "
                  f"ms by {m['bound_by']}", flush=True)
    out["gru_scan_backward"]["library_ms"] = cudnn_gru_backward_ms()
    for name, m in out.items():
        m["max_abs_err"] = errs[name]
        print(f"time {name} at the slice, bf16, on {card}: kernel "
              f"{m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, bound "
              f"{m['bound_ms']:.4f} ms by {m['bound_by']}, library call "
              f"{m['library_ms'] and round(m['library_ms'], 4)} ms",
              flush=True)
    return out


def heads_times_ms(shape) -> dict:
    """Times of the fused heads kernels at `shape` in bf16: the tensor-core
    route, the SIMT kernels of the same inputs (the route forced), the plain
    versions and the bound; the kernels' from the replay of a CUDA graph of
    10 calls."""
    T, B, C, K, D, shift = shape
    p, z, g = heads_inputs(T, B, C, K, D, torch.bfloat16, seed=30)
    nll, cor, lse = heads_nll_reference(p, z, shift, K)
    outs = heads_nll_backward_reference(g, lse, p, z, shift, K)
    on_card = dict(reps=10, inner=10, graph=True)
    scores = 2 * T * K * B * C * D

    def fwd():
        return heads_nll_forward(p, z, shift, K)

    def bwd():
        return heads_nll_backward(g, lse, p, z, shift, K)
    times = {"heads_nll_forward": {
        "plain_ms": cuda_ms(lambda: heads_nll_reference(p, z, shift, K),
                            reps=5),
        **bound([p, z, nll, cor, lse], scores)},
        "heads_nll_backward": {
        "plain_ms": cuda_ms(lambda: heads_nll_backward_reference(
            g, lse, p, z, shift, K), reps=5),
        # the scores again, dz and dp
        **bound([g, lse, p, z, *outs], 3 * scores)}}
    for name, fn in (("heads_nll_forward", fwd), ("heads_nll_backward", bwd)):
        m = times[name]
        m["ms"] = cuda_ms(fn, **on_card)
        with forced("_MMA_DTYPES", (), module=infonce_fused):
            m["simt_ms"] = cuda_ms(fn, **on_card)
    return times


BACKWARD_STAGES = {"gates": ("gru_gates_kernel",),
                   "recurrence": ("gru_bwd_resident_kernel",
                                  "gru_scan_bwd_kernel"),
                   "reduction": ("gru_bwd_reduce_kernel",
                                 "gru_bwd_finish_kernel")}


def gru_backward_stages_ms(args, calls=5) -> dict:
    """Device ms a call of each stage of `gru_scan_backward(*args)`, by
    kernel name, from torch.profiler over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile
    gru_scan_backward(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            gru_scan_backward(*args)
        torch.cuda.synchronize()
    out = dict.fromkeys(BACKWARD_STAGES, 0.0)
    for ev in prof.key_averages():
        for stage, names in BACKWARD_STAGES.items():
            if any(name in ev.key for name in names):
                out[stage] += ev.device_time_total / calls / 1e3
    check(all(v > 0 for v in out.values()), f"a stage without time: {out}")
    return out


def cudnn_gru(T, B, H, dtype=torch.bfloat16):
    """torch.nn.GRU in `dtype` on the card with its input x (T, B, H) and
    h0: cuDNN's GRU, timed as the library yardstick and used by nothing
    else. cuDNN does not flatten bf16 RNN weights, so torch warns; the
    per-call copy it makes is 0.8 MB."""
    gru = torch.nn.GRU(H, H).to("cuda", dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((T, B, H), device="cuda", generator=gen).to(dtype)
    h0 = torch.zeros((1, B, H), device="cuda", dtype=dtype)
    return gru, x, h0


def cudnn_gru_backward_ms() -> float:
    """cuDNN's GRU backward at the slice's shape (it also returns the
    gradients of the input projection)."""
    gru, x, h0 = cudnn_gru(*SLICE_SHAPE)
    x.requires_grad_()
    out, _ = gru(x, h0)
    g = torch.randn_like(out)
    wanted = [x, *gru.parameters()]
    return cuda_ms(lambda: torch.autograd.grad(out, wanted, g,
                                               retain_graph=True))


# ---------------------------------------------------------- phases 6 and 9
TRAIN_STEPS = 10
COUNTED = {"gru_scan": gru_scan, "gru_scan_backward": gru_scan_backward,
           "heads_nll_forward": heads_nll_forward,
           "heads_nll_backward": heads_nll_backward,
           "same_step_nll_forward": same_step_nll_forward,
           "same_step_nll_backward": same_step_nll_backward,
           "allsteps_nll_forward": allsteps_nll_forward,
           "allsteps_nll_backward": allsteps_nll_backward,
           "flash_attention_forward": flash_attention_forward,
           "flash_attention_backward": flash_attention_backward,
           "flash_attention_dq": flash_attention_dq,
           "flash_attention_dkv": flash_attention_dkv,
           "conv_pyramid_forward": conv_pyramid_forward}
GRU_KERNELS = ("gru_scan", "gru_scan_backward")
HEADS_KERNELS = ("heads_nll_forward", "heads_nll_backward")
ATTN_KERNELS = ("flash_attention_forward", "flash_attention_backward",
                "flash_attention_dq", "flash_attention_dkv")
# the attention kernels a training step launches, by ar.attn_impl
ATTN_ON_PATH = {"flash16": ATTN_KERNELS[:2],
                "flash": (ATTN_KERNELS[0],) + ATTN_KERNELS[2:], "xla": ()}
LOSS_PATHS = {  # the CLI's --set, and the loss kernels the path launches
    "fused": ([], ("heads_nll_forward", "heads_nll_backward")),
    "all_steps": (["--set", "model.loss.negatives=all_steps"],
                  ("allsteps_nll_forward", "allsteps_nll_backward")),
    "fuse_heads=false": (["--set", "model.loss.fuse_heads=false"],
                         ("same_step_nll_forward",
                          "same_step_nll_backward"))}


def train_through_cli(path: str) -> dict:
    """Trains tpu_fast through the CLI's main on the loss path `path`;
    returns every kernel's launch count, checked: the GRU's and the path's
    kernels once per step, the others never."""
    extra, launched = LOSS_PATHS[path]
    return train_cli_run(path, "tpu_fast", extra, TRAIN_STEPS,
                         {k: 1 for k in GRU_KERNELS + launched})


def train_cli_run(label: str, config: str, extra, steps: int,
                  per_step: dict, workdir=None) -> dict:
    """Trains `config` through `cpc_tpu_torch.train.cli.main` for `steps`
    steps with the arguments `extra`, every count set to 0 just before, in
    `workdir` (else a temporary one). Checks the metrics, the checkpoint
    and every kernel's launch count: per_step[name] per step, 0 for a
    kernel it does not name. Returns the counts."""
    for fn in COUNTED.values():
        fn.launches = 0
    with (contextlib.nullcontext(workdir) if workdir
          else tempfile.TemporaryDirectory()) as workdir:
        t0 = time.perf_counter()
        rc = train_cli.main(["--config", config, "--data", "synthetic",
                             "--steps", str(steps), "--workdir", workdir,
                             *extra])
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in COUNTED.items()}
        check(rc == 0, f"train cli returned {rc}")
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        check(bool(recs), "no metrics written")
        for rec in recs:
            for k, v in rec.items():
                vals = v if isinstance(v, list) else [v]
                check(all(not isinstance(x, float) or math.isfinite(x)
                          for x in vals), f"non-finite metric {k}: {v}")
        check(recs[-1]["step"] == steps, f"last step {recs[-1]}")
        ckpts = os.listdir(os.path.join(workdir, "checkpoints"))
        check(f"step_{steps}.pt" in ckpts, f"checkpoints: {ckpts}")
    print(f"train ({label}): {steps} steps of {config} through "
          f"cpc_tpu_torch.train.cli.main in {wall:.2f} s (corpus, build "
          f"and warm-up included); last log {json.dumps(recs[-1])}; "
          f"launches {counts}", flush=True)
    for name, n in counts.items():
        want = steps * per_step.get(name, 0)
        check(n == want, f"{label}: {name} launched {n} times, expected "
              f"{want}")
    return counts


# --------------------------------------------------------- phases 7 and 10
def plain_context(gar, z):
    """c (B, T, d_ar) of the transformer gar `gar` with its attention on the
    plain Function: CausalTransformer.forward (no dropout, no remat)
    composed from the module's own parts."""
    x = gar.in_proj(z) + gar.pos_embed[:z.shape[1]].to(gar.dtype)[None]
    for blk in gar.blocks():
        attn = blk.attn
        q, k, v = (attn.heads(proj, blk.ln_attn(x))
                   for proj in (attn.query, attn.key, attn.value))
        o = _FlashPlain.apply(q, k, v, float(q.shape[-1]) ** -0.5,
                              attn.p_dtype)
        x = x + attn.out(o.reshape(x.shape))
        x = x + blk.mlp(x)
    return gar.final_norm(x)


def pyramid_args(encoder, x):
    """What `ConvEncoder.forward` hands the conv pyramid under
    `use_pallas`."""
    ec = encoder.config
    convs = [getattr(encoder, f"conv{i}") for i in range(len(ec.kernels))]
    return (x.to(encoder.dtype).contiguous(), tuple(ec.kernels),
            tuple(ec.strides), *(c.weight.to(encoder.dtype) for c in convs),
            *(c.bias.to(encoder.dtype) for c in convs))


def plain_encode(encoder, x):
    """z of a `use_pallas` encoder on the plain Function."""
    return _ConvPyramidPlain.apply(*pyramid_args(encoder, x))


def plain_loss(model, batch, cfg):
    """The loss of `cfg` composed from the model's modules and the plain
    GRU, attention and loss Functions (the package has no switch for
    this)."""
    loss = cfg.model.loss
    K = loss.prediction_steps
    kd = torch.bfloat16 if loss.pallas_bf16 else torch.float32
    x = device_prepare(batch, cfg.data.normalize)
    z = plain_encode(model.encoder, x) if cfg.model.encoder.use_pallas \
        else model.encoder(x)
    if cfg.model.ar.kind == "transformer":
        h = plain_context(model.gar, z)
        hs = h.transpose(0, 1)
    else:
        h = z
        for layer in model.gar.layers():
            hs = _GruScanPlain.apply(*layer.scan_inputs(h, None))  # (T, B, H)
            h = hs.transpose(0, 1)
    B, T, _ = z.shape
    if loss.fuse_heads and loss.negatives == "same_step":
        W = model.prediction_heads.weight.t().to(kd)
        nll, cor = _HeadsNllPlain.apply(hs.to(kd).contiguous(),
                                        z.to(kd).transpose(0, 1).contiguous(),
                                        W, 0, K)
        return reduce_heads_nll(nll, cor, K, B)
    preds_v = model.predict(h).reshape(B, T, K, -1)[:, :T - K].to(kd)
    if loss.negatives == "all_steps":
        nll, cor = _AllStepsNllPlain.apply(preds_v, z.to(kd).contiguous(), 0)
        return reduce_allsteps_nll(nll, cor, T - K, K, B)
    nll, cor = _SameStepNllPlain.apply(preds_v, z.to(kd), 0)
    return reduce_same_step_nll(nll, cor, K, B)


# The two steps share the encoder's cuDNN calls exactly; they differ only in
# the GRU's and the loss's fp32 summation order. Loss and grad_norm
# relative, acc absolute (4e-4 is 3 of the 7 424 rows of a k, for argmax
# near-ties). Grads twice: relative to max(1, max |grad|), which for these
# gradients (all below 1) is the absolute error, and relative to their
# largest entry, where one bf16 rounding (2**-8) of an activation gradient
# shows. Measured on an H100 80GB HBM3 at 700 W on the fused path: loss
# 2.3e-7, acc 0, grad_norm 2.4e-6, grads 3.8e-6 absolute (wh) and 1.9e-6
# (W), 2.3e-3 and 4.4e-3 of their largest entry.
STEP_TOL = {"loss": 1e-6, "acc": 4e-4, "grad_norm": 1e-5, "grad": 1e-4,
            "grad_of_max": 1e-2}


# The transformer step, kernels against plain. Under 'flash16' the kernels
# round P and dS to bf16 relative to a running max over 64-wide tiles, the
# plain versions relative to the row's max; under 'flash' the attention
# differs by fp32 summation order only. Either way o is then rounded to
# bf16, an entry near a rounding edge lands one bf16 ulp (2**-8) apart, and
# two blocks, the heads and the loss carry that on, so the bounds are wider
# than STEP_TOL's but for grad_of_max. Measured on an H100 80GB HBM3 at
# 700 W, flash16 and flash: loss 1.6e-6 and 8.3e-7, acc 4.0e-4 (3 rows of
# 7 424) and 1.3e-4 (1 row), grad_norm 6.4e-6 and 4.6e-5, grads 7.6e-6 (query
# weight) and 2.4e-4 (in_proj) absolute, 5.6e-3 and 4.6e-3 of their largest
# entry.
TRANSFORMER_STEP_TOL = {"loss": 1e-5, "acc": 1e-3, "grad_norm": 1e-4,
                        "grad": 1e-3, "grad_of_max": 2e-2}


def step_vs_plain(card: str, path: str, watched_names, config="tpu_fast",
                  overrides=None, tols=None, compare=True) -> None:
    """One full-width step of `config` (loss path `path` of tpu_fast unless
    `overrides` are given) through the kernels against the same step
    through the plain versions (unless not `compare`), then its steady
    time."""
    cfg = presets.by_name(config)
    tols = tols or STEP_TOL
    if overrides is None:
        overrides = [a for a in LOSS_PATHS[path][0] if a != "--set"]
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    model = init_state(cfg, "cuda")
    steps = make_step_fns(cfg, model)
    B, S = cfg.data.batch_size, cfg.data.snippet_samples
    batch = torch.from_numpy(np.clip(np.random.default_rng(3).standard_normal(
        (B, S)) * 3000, -32768, 32767).astype(np.int16)).cuda()
    params = dict(model.named_parameters())
    watched = {k: params[k] for k in watched_names}
    results = []
    loss_fns = (steps.loss_fn, lambda m, b: plain_loss(m, b, cfg))
    for loss_fn in loss_fns if compare else ():
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        results.append((metrics["loss"].item(), metrics["acc"].float().cpu(),
                        global_norm(p.grad for p in model.parameters()).item(),
                        {k: p.grad.clone() for k, p in watched.items()}))
    if compare:
        (loss, acc, gn, grads), (p_loss, p_acc, p_gn, p_grads) = results
        errs = {"loss": abs(loss - p_loss) / abs(p_loss),
                "acc": (acc - p_acc).abs().max().item(),
                "grad_norm": abs(gn - p_gn) / p_gn}
        for k in watched:
            errs[f"grad {k}"] = rel_err(grads[k], p_grads[k])
            errs[f"grad_of_max {k}"] = (
                (grads[k] - p_grads[k]).abs().max()
                / p_grads[k].abs().max()).item()
        print(f"step vs plain step ({config}, {path}, bf16, batch {B}): "
              f"loss {loss:.6f} vs {p_loss:.6f}, grad_norm {gn:.6f} vs "
              f"{p_gn:.6f}, acc {acc.tolist()}; errors {errs} (tolerances "
              f"{tols}: relative for loss and grad_norm, absolute for acc, "
              f"relative to max(1, max |grad|) for grad and to max |grad| "
              f"for grad_of_max)", flush=True)
        for k, e in errs.items():
            check(math.isfinite(e) and e <= tols[k.split()[0]],
                  f"step vs plain ({config}, {path}): {k} error {e}")

    def timed(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out)

    def plain_step():
        model.zero_grad(set_to_none=True)
        plain_loss(model, batch, cfg)[0].backward()

    timed(lambda: steps.train_step(batch), 3)  # warm-up
    step_s = timed(lambda: steps.train_step(batch), 10)
    plain = f"{timed(plain_step, 3) * 1e3:.2f} ms" if compare \
        else "not composed (no kernel on this path's attention)"
    audio = B * S / cfg.data.sample_rate
    print(f"train step ({config}, {path}, batch {B} x {S} samples = "
          f"{audio:.2f} audio-s, device-resident batch) on {card}: "
          f"{step_s * 1e3:.2f} ms median of 10 = {audio / step_s:.1f} "
          f"audio-s/s; the plain step (forward and backward only, context) "
          f"{plain}", flush=True)


# ---------------------------------------------------------------- phase 8
LOSS_SLICE = (64, 128, 64, 12, 512, 0)  # B, T, C, K, D, shift of tpu_fast
# transformer_fast at its long context: T = 1 024, batch 16, C = B
LOSS_LONG = (16, 1024, 16, 12, 512, 0)
LOSS_CASES = [(LOSS_SLICE, torch.bfloat16), (LOSS_SLICE, torch.float32),
              ((3, 20, 6, 3, 40, 3), torch.bfloat16),
              ((3, 20, 6, 3, 40, 3), torch.float32),
              (LOSS_LONG, torch.bfloat16),
              # R = 660, N = 333 and D = 72: no multiple of any tile
              ((5, 37, 9, 4, 72, 2), torch.bfloat16)]
# the route each wire dtype takes at these shapes (D % 8 == 0)
ALLSTEPS_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
SAME_STEP_ROUTES = {torch.bfloat16: "mma", torch.float32: "simt"}
# The bf16 same-step backward's dpreds and dz on their share of entries
# whose bf16 rounding differs from plain's, held where an output has at
# least FLIP_MIN_ENTRIES entries: the limits of the heads backward
# (HEADS_FLIP_TOL), which computes the same products. Held once against the
# kernel built with delta in two bf16 terms, which must fail them.
SAME_STEP_FLIP_TOL = {"dpreds": HEADS_FLIP_TOL["dp"],
                      "dz": HEADS_FLIP_TOL["dz"]}
LOSS_KERNELS = {
    "same_step": (same_step_nll_forward, same_step_nll_reference,
                  same_step_nll_backward, same_step_nll_backward_reference),
    "allsteps": (allsteps_nll_forward, allsteps_nll_reference,
                 allsteps_nll_backward, allsteps_nll_backward_reference)}
# Gradients relative to max |plain|. fp32 differs by summation order: 1e-5
# where a sum has at most K*B = 768 or C*T = 8 192 terms, 1e-4 for the
# all-steps dz, a sum over all R = 89 088 rows (1.6e-5 measured). bf16
# outputs differ by one rounding of the output (2**-9 of an entry) where
# the fp32 sum lands near a rounding edge.
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DEEP_SUM_TOL = 1e-4


def loss_inputs(B, T, C, K, D, dtype, seed):
    """Seeded preds_v (B, Tp, K, D), z_pool (C, T, D) and the cotangents of
    the same-step (T-1, K*B) and all-steps (R,) rows. As on the training
    path, an fp32 preds_v is the window of the (B, T, K, D) predictions and
    a bf16 one its contiguous cast."""
    rng = np.random.default_rng(seed)
    preds = rng.standard_normal((B, T, K, D)) / np.sqrt(D)
    z = rng.standard_normal((C, T, D))
    g = {"same_step": rng.standard_normal((T - 1, K * B)),
         "allsteps": rng.standard_normal((T - K) * K * B)}

    def dev(a, dt):
        return torch.from_numpy(a).to("cuda", dt).contiguous()
    preds_v = dev(preds, torch.float32)[:, :T - K].to(dtype)
    return (preds_v, dev(z, dtype),
            {k: dev(v, torch.float32) for k, v in g.items()})


def phase8_kernels(card: str) -> dict:
    """The same-step and all-steps kernels against their plain versions;
    returns {name: {max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by}}."""
    errs = {f"{k}_nll_{half}": 0.0 for k in LOSS_KERNELS
            for half in ("forward", "backward")}
    with torch.inference_mode():
        for n, ((B, T, C, K, D, shift), dtype) in enumerate(LOSS_CASES):
            preds_v, z, gs = loss_inputs(B, T, C, K, D, dtype, seed=40 + n)
            for kind, (fwd, fwd_ref, bwd, bwd_ref) in LOSS_KERNELS.items():
                what = f"{kind} {(B, T, C, K, D)} shift {shift} " \
                       f"{str(dtype)[6:]}"
                if kind == "allsteps":
                    plan = allsteps_route((T - K) * K * B, C * T, D, dtype)
                    print(f"{what}: route {plan.route}, dZ row groups "
                          f"{plan.groups}", flush=True)
                    check(plan.route == ALLSTEPS_ROUTES[dtype],
                          f"{what}: route {plan.route}")
                else:
                    route = same_step_route(T, B, C, K, D, dtype)
                    print(f"{what}: route {route}", flush=True)
                    check(route == SAME_STEP_ROUTES[dtype],
                          f"{what}: route {route}")
                nll, cor, lse = fwd(preds_v, z, shift)
                r_nll, r_cor, r_lse = fwd_ref(preds_v, z, shift)
                torch.cuda.synchronize()
                check(nll.shape == r_nll.shape, f"{what}: {nll.shape}")
                check(bool(torch.isfinite(nll).all()), f"{what}: non-finite")
                err = max((nll - r_nll).abs().max().item(),
                          (lse - r_lse).abs().max().item())
                miss = (cor != r_cor).float().mean().item()
                name = f"{kind}_nll_forward"
                errs[name] = max(errs[name], err)
                print(f"{name} vs plain {what}: nll/lse max abs err "
                      f"{err:.3e} (tol {NLL_TOL:.0e}), argmax mismatch "
                      f"share {miss:.2e} (tol {MISMATCH_TOL:.0e})",
                      flush=True)
                check(err <= NLL_TOL and miss <= MISMATCH_TOL,
                      f"{what} forward error {err}, mismatch {miss}")
                got = bwd(gs[kind], r_lse, preds_v, z, shift)
                again = bwd(gs[kind], r_lse, preds_v, z, shift)
                want = bwd_ref(gs[kind], r_lse, preds_v, z, shift)
                torch.cuda.synchronize()
                name = f"{kind}_nll_backward"
                for out, a, a2, b in zip(("dpreds", "dz"), got, again, want):
                    check(a.dtype == b.dtype == dtype and a.shape == b.shape,
                          f"{what} {out}: {a.dtype} {tuple(a.shape)}")
                    check(torch.equal(a, a2),
                          f"{what} {out} differs between two runs")
                    abs_err = (a.float() - b.float()).abs().max().item()
                    err = abs_err / b.float().abs().max().item()
                    deep = (kind, out, dtype) == ("allsteps", "dz",
                                                  torch.float32)
                    tol = DEEP_SUM_TOL if deep else GRAD_TOL[dtype]
                    errs[name] = max(errs[name], abs_err)
                    flips = ""
                    if kind == "same_step" and dtype == torch.bfloat16:
                        flips = same_step_flips(out, a, b, check_it=True)
                    print(f"{name} vs plain {what} {out}: max abs err "
                          f"{abs_err:.3e}, relative to max |plain| "
                          f"{err:.3e} (tol {tol:.0e}){flips}; two runs "
                          f"bit-identical", flush=True)
                    check(err <= tol, f"{what} {out} error {err} > {tol}")
                if kind == "same_step":
                    check(got[1][:, 0].abs().max().item() == 0.0,
                          f"{what}: dz[:, 0] is not zero")
                if kind == "same_step" and (B, T, C, K, D, shift) == \
                        LOSS_SLICE and dtype == torch.bfloat16:
                    worse_flips_fail(gs[kind], r_lse, preds_v, z, shift,
                                     want)

    out = {}
    for shape in (LOSS_SLICE, LOSS_LONG):
        times = loss_times_ms(shape, tuple(LOSS_KERNELS))
        if shape == LOSS_SLICE:
            out = times
        for name, m in times.items():
            simt = f" [SIMT kernels of the same call {m['simt_ms']:.4f} " \
                f"ms]" if "simt_ms" in m else ""
            print(f"time {name} at {shape[:5]}, bf16, on {card}: kernel "
                  f"{m['ms']:.4f} ms = {m['tflops']:.1f} TFLOP/s{simt}, "
                  f"plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} "
                  f"ms by {m['bound_by']}", flush=True)
        if "product_ms" in times.get("allsteps_nll_forward", {}):
            m = times["allsteps_nll_forward"]
            print(f"time of the all-steps score product alone on cuBLAS "
                  f"(torch.matmul of (R, D) and (D, N) bf16, another "
                  f"function: a yardstick, not library_ms) at "
                  f"{shape[:5]} on {card}: {m['product_ms']:.4f} ms = "
                  f"{m['product_tflops']:.1f} TFLOP/s", flush=True)
    for name, m in out.items():
        m.update(max_abs_err=errs[name], library_ms=None)
    return out


def same_step_flips(out: str, got, want, check_it: bool) -> str:
    """The share of `got`'s entries whose bf16 rounding differs from
    plain's, held to SAME_STEP_FLIP_TOL (if `check_it`) where `got` has
    at least FLIP_MIN_ENTRIES entries; returns the reading for the log."""
    flips = bf16_flips(got, want)
    tol = SAME_STEP_FLIP_TOL[out]
    if got.numel() < FLIP_MIN_ENTRIES:
        return f", bf16 flips {flips:.3e} (not held: {got.numel()} entries)"
    if check_it:
        check(flips <= tol, f"same-step {out} bf16 flips {flips} > {tol}")
    return f", bf16 flips {flips:.3e} (tol {tol:.0e})"


def two_term_library() -> ctypes.CDLL:
    """infonce_same_step.cu built again with delta in two bf16 terms
    (CPC_DELTA_TERMS=2): a deliberately worse same-step backward, with the
    signatures of the kernels' library."""
    lib = _build.load_library()
    out = _build.BUILD_DIR / "same_step_two_terms.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DCPC_DELTA_TERMS=2",
                    "-shared", "-o", str(out),
                    str(_build.CSRC / "infonce_same_step.cu")],
                   check=True, capture_output=True, text=True, timeout=600)
    worse = ctypes.CDLL(str(out))
    worse.same_step_nll_bwd.argtypes = lib.same_step_nll_bwd.argtypes
    worse.same_step_nll_bwd.restype = lib.same_step_nll_bwd.restype
    worse.cpc_error_string = lib.cpc_error_string
    return worse


def worse_flips_fail(g, lse, preds_v, z, shift, want) -> None:
    """The same-step flip check against the two-term kernel: at least one
    of dpreds and dz must fail it, else the limits could not fail (C10)."""
    worse = two_term_library()
    with forced("load_library", lambda: worse, module=infonce_cuda):
        got = same_step_nll_backward(g, lse, preds_v, z, shift)
    torch.cuda.synchronize()
    failed = []
    for out, a, b in zip(("dpreds", "dz"), got, want):
        reading = same_step_flips(out, a, b, check_it=False)
        print(f"same_step_nll_backward with delta in 2 bf16 terms (a "
              f"deliberately worse kernel) {out}: max abs err "
              f"{(a.float() - b.float()).abs().max().item():.3e}{reading}",
              flush=True)
        if bf16_flips(a, b) > SAME_STEP_FLIP_TOL[out]:
            failed.append(out)
    check(bool(failed), "the two-term same-step kernel holds the flip "
          "limits: they cannot tell it from the built one")
    print(f"the two-term kernel fails the flip limits on {failed}, as it "
          f"must", flush=True)


def loss_times_ms(shape, kinds) -> dict:
    """Kernel and plain times of the `kinds` of LOSS_KERNELS at `shape`
    (B, T, C, K, D, shift) in bf16, with the bound and the achieved TFLOP/s
    of the products the function needs (forward: the scores; backward: the
    scores again and the two contractions); for the same-step kernels also
    their SIMT kernels on the same inputs (the route forced), both from the
    replay of a CUDA graph of 10 calls; for the all-steps forward the score
    product alone on cuBLAS. CUDA events, medians."""
    B, T, C, K, D, shift = shape
    with torch.inference_mode():
        preds_v, z, gs = loss_inputs(B, T, C, K, D, torch.bfloat16, seed=40)
        flops = {"same_step": 2 * (T - K) * K * B * C * D,
                 "allsteps": 2 * (T - K) * K * B * C * T * D}
        out = {}
        for kind in kinds:
            fwd, fwd_ref, bwd, bwd_ref = LOSS_KERNELS[kind]
            same_step = kind == "same_step"
            reps = 20 if same_step else 5
            timing = dict(reps=10, inner=10, graph=True) if same_step \
                else dict(reps=reps)
            fwd_outs = fwd_ref(preds_v, z, shift)
            lse, g = fwd_outs[2], gs[kind]
            bwd_outs = bwd(g, lse, preds_v, z, shift)
            halves = {
                f"{kind}_nll_forward": (
                    lambda: fwd(preds_v, z, shift),
                    lambda: fwd_ref(preds_v, z, shift), flops[kind],
                    [preds_v, z, *fwd_outs]),
                f"{kind}_nll_backward": (
                    lambda: bwd(g, lse, preds_v, z, shift),
                    lambda: bwd_ref(g, lse, preds_v, z, shift),
                    3 * flops[kind], [g, lse, preds_v, z, *bwd_outs])}
            for name, (kernel, plain, work, tensors) in halves.items():
                ms = cuda_ms(kernel, **timing)
                out[name] = {"ms": ms, "tflops": work / ms / 1e9,
                             "plain_ms": cuda_ms(plain, reps=reps),
                             **bound(tensors, work)}
                if same_step:
                    with forced("_MMA_DTYPES", (), module=infonce_cuda):
                        out[name]["simt_ms"] = cuda_ms(kernel, **timing)
            if kind == "allsteps":
                rows = preds_v.permute(1, 2, 0, 3).reshape(-1, D)
                cols = z.reshape(-1, D)
                ms = cuda_ms(lambda: torch.matmul(rows, cols.T), reps=reps)
                out["allsteps_nll_forward"].update(
                    product_ms=ms, product_tflops=flops[kind] / ms / 1e9)
    return out


# --------------------------------------------------------------- phase 11
ATTN_FAST = (64, 128, 8, 32)    # (B, T, H, Dh) of transformer_fast
ATTN_LONG = (16, 1024, 8, 32)   # the long-context run of phase 12
ATTN_SHAPES = (ATTN_FAST, ATTN_LONG, (2, 200, 3, 16))
ATTN_MODES = (("bf16 flash16", torch.bfloat16, "bfloat16"),
              ("bf16 flash", torch.bfloat16, "float32"),
              ("fp32 flash", torch.float32, "float32"))
# o and the gradients relative to max(1, max |plain|): fp32 differs by
# summation order (a gradient row sums up to 1 024 terms); with bf16 anywhere
# the kernel rounds P and dS relative to a running max and the plain version
# relative to the row's max, and a bf16 output rounds once more (2**-9).
# lse is fp32 from exact products in every mode.
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LSE_TOL = 1e-4


def attn_inputs(B, T, H, Dh, dtype, seed):
    """Seeded q, k, v and a cotangent, (B, T, H, Dh), distinct per head."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, T, H, Dh))
                             ).to("cuda", dtype) for _ in range(4)]


def attn_work(B, T, H, Dh, products: int) -> float:
    """Operations of `products` matrix products over the causal half of the
    (T, T) scores: T (T + 1) / 2 positions a (batch, head)."""
    return products * 2.0 * Dh * (T * (T + 1) // 2) * B * H


# the one-pass backward's other route, by the route a shape takes: the
# constants of `attention_cuda` that send it there
OTHER_ROUTE = {"one_pass_resident": ("_RESIDENT_MIN_HEADS", 1 << 30),
               "one_pass_split": ("_RESIDENT_MIN_HEADS", 1)}


def phase11_kernels(card: str) -> dict:
    """The four attention kernels against their plain versions; returns
    {name: {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}} at
    transformer_fast's shape."""
    names = ATTN_KERNELS
    errs = dict.fromkeys(names, 0.0)
    with torch.inference_mode():
        for n, shape in enumerate(ATTN_SHAPES):
            for mode, dtype, p_dtype in ATTN_MODES:
                q, k, v, do = attn_inputs(*shape, dtype, seed=50 + n)
                scale = shape[3] ** -0.5
                what = f"{shape} {mode}"
                route = attention_route(*shape, dtype, p_dtype)
                o, lse = flash_attention_forward(q, k, v, scale, p_dtype)
                r_o, r_lse = flash_attention_forward_reference(q, k, v, scale,
                                                               p_dtype)
                dres = row_dot(do, r_o)
                args = (q, k, v, do, r_lse, dres, scale, p_dtype)
                r_dq, r_dk, r_dv = flash_attention_backward_reference(*args)
                # (kernel, route, dq, dk, dv), each run twice
                runs = []
                one_pass = route.backward != "pair"
                before = flash_attention_backward.launches
                for _ in range(2):
                    runs.append((names[1] if one_pass else "pair",
                                 route.backward,
                                 *flash_attention_backward(*args)))
                check(flash_attention_backward.launches - before
                      == 2 * one_pass, f"{what}: route {route.backward} but "
                      f"{flash_attention_backward.launches - before} "
                      f"launches of the one-pass kernel")
                if one_pass:
                    with forced(*OTHER_ROUTE[route.backward],
                                module=attention_cuda):
                        other = attention_route(*shape, dtype, p_dtype)
                        for _ in range(2 * (other.backward != route.backward)):
                            runs.append((names[1], other.backward,
                                         *flash_attention_backward(*args)))
                for _ in range(2):
                    dk, dv = flash_attention_dkv(*args)
                    runs.append(("pair", "pair", flash_attention_dq(*args),
                                 dk, dv))
                torch.cuda.synchronize()
                lse_err = (lse - r_lse).abs().max().item()
                check(lse_err <= LSE_TOL, f"{what}: lse error {lse_err}")
                tol = ATTN_TOL[dtype]
                line = [f"forward ({route.forward}): lse max abs err "
                        f"{lse_err:.3e} (tol {LSE_TOL:.0e})"]
                compared = [(names[0], "o", o, r_o)]
                for first, again in zip(runs[::2], runs[1::2]):
                    check(all(torch.equal(a, b)
                              for a, b in zip(first[2:], again[2:])),
                          f"{what}: the backward ({first[1]}) differs "
                          f"between two runs")
                    kernel, via, dq, dk, dv = first
                    line.append(f"backward ({via})")
                    compared += [
                        (names[2] if kernel == "pair" else kernel, "dq", dq,
                         r_dq),
                        (names[3] if kernel == "pair" else kernel, "dk", dk,
                         r_dk),
                        (names[3] if kernel == "pair" else kernel, "dv", dv,
                         r_dv)]
                for name, out, a, b in compared:
                    check(a.dtype == b.dtype == dtype and a.shape == b.shape
                          and a.is_contiguous(),
                          f"{what} {out}: {a.dtype} {tuple(a.shape)}")
                    check(bool(torch.isfinite(a.float()).all()),
                          f"{what} {out}: non-finite")
                    abs_err = (a.float() - b.float()).abs().max().item()
                    err = rel_err(a, b)
                    errs[name] = max(errs[name], abs_err)
                    line.append(f"{out} max abs err {abs_err:.3e}, relative "
                                f"to max(1, max |plain|) {err:.3e}")
                    check(err <= tol, f"{what} {out} error {err} > {tol}")
                print(f"flash attention vs plain {what}: {'; '.join(line)} "
                      f"(tol {tol:.0e}); every backward bit-identical over "
                      f"two runs", flush=True)

    out = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # every call here runs for microseconds: the card's time comes from the
    # replay of a CUDA graph of 20 calls, the eager call's (what a training
    # step sees, with the host's enqueue) is printed beside it
    on_card = dict(reps=10, inner=20, graph=True)
    eager = dict(reps=10, inner=20)
    for shape in (ATTN_LONG, ATTN_FAST):  # the main path's shape last: kept
        B, T, H, Dh = shape
        q, k, v, do = attn_inputs(*shape, torch.bfloat16, seed=50)
        scale = Dh ** -0.5
        route = attention_route(*shape, torch.bfloat16, "bfloat16")
        with torch.inference_mode():
            o, lse = flash_attention_forward_reference(q, k, v, scale,
                                                       "bfloat16")
            dres = row_dot(do, o)
            args = (q, k, v, do, lse, dres, scale, "bfloat16")
            dq, dk, dv = flash_attention_backward(*args)
            calls = {
                names[0]: (lambda: flash_attention_forward(
                    q, k, v, scale, "bfloat16"),
                    lambda: flash_attention_forward_reference(
                        q, k, v, scale, "bfloat16"),
                    bound([q, k, v, o, lse], attn_work(*shape, 2))),
                names[1]: (lambda: flash_attention_backward(*args),
                           lambda: flash_attention_backward_reference(*args),
                           bound([q, k, v, do, lse, dres, dq, dk, dv],
                                 attn_work(*shape, 5))),
                names[2]: (lambda: flash_attention_dq(*args),
                           lambda: flash_attention_dq_reference(*args),
                           bound([q, k, v, do, lse, dres, dq],
                                 attn_work(*shape, 3))),
                names[3]: (lambda: flash_attention_dkv(*args),
                           lambda: flash_attention_dkv_reference(*args),
                           bound([q, k, v, do, lse, dres, dk, dv],
                                 attn_work(*shape, 4)))}
            out = {name: {"ms": cuda_ms(kernel, **on_card),
                          "eager_ms": cuda_ms(kernel, **eager),
                          "plain_ms": cuda_ms(plain, reps=5), **bnd}
                   for name, (kernel, plain, bnd) in calls.items()}
            # the launch floor: an empty kernel at the grid, block and
            # shared memory the library launches, over the same replay
            launches = {half: launch_shape(half, *shape, route.groups)
                        for half in ("forward", "backward")}
            floors = {half: cuda_ms(lambda: launch_floor(launch, q.device),
                                    **on_card)
                      for half, launch in launches.items()}
            # beside them: the one-pass backward on its other route
            with forced(*OTHER_ROUTE[route.backward], module=attention_cuda):
                other = attention_route(*shape, torch.bfloat16, "bfloat16")
                other_ms = cuda_ms(lambda: flash_attention_backward(*args),
                                   **on_card)
            simt = (q, k, v, do, lse, dres, scale, "float32")
            fwd_ms = cuda_ms(lambda: flash_attention_forward(
                q, k, v, scale, "float32"), **on_card)
            dq_ms = cuda_ms(lambda: flash_attention_dq(*simt), **on_card)
            dkv_ms = cuda_ms(lambda: flash_attention_dkv(*simt), **on_card)
        print(f"time at {shape}, bf16 flash16, on {card}: forward "
              f"({route.forward}, launch {launches['forward']}) "
              f"{out[names[0]]['ms']:.4f} ms, its launch floor (an empty "
              f"kernel) {floors['forward']:.4f} ms; one-pass backward "
              f"({route.backward}, launch {launches['backward']}) "
              f"{out[names[1]]['ms']:.4f} "
              f"ms, its launch floor {floors['backward']:.4f} ms, on its "
              f"other route ({other.backward}, groups {other.groups}) "
              f"{other_ms:.4f} ms, the pair it replaced "
              f"{out[names[2]]['ms'] + out[names[3]]['ms']:.4f} ms",
              flush=True)
        print(f"time at {shape}, bf16 flash (fp32 P: its products on the "
              f"SIMT pipe), on {card}: forward {fwd_ms:.4f} ms, dq "
              f"{dq_ms:.4f} ms, dkv {dkv_ms:.4f} ms", flush=True)
        # the library yardstick, used nowhere in the port: one fused call
        # for the forward; its backward returns dq, dk and dv together (so
        # the same time stands beside all three backward kernels) and is
        # timed as forward + backward less the forward
        lq, lk, lv = (a.transpose(1, 2).detach().requires_grad_()
                      for a in (q, k, v))
        lg = do.transpose(1, 2)

        def library_step():
            lo = sdpa(lq, lk, lv, is_causal=True)
            torch.autograd.grad(lo, (lq, lk, lv), lg)

        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: sdpa(lq, lk, lv, is_causal=True),
                              **on_card)
        lib_bwd = cuda_ms(library_step, **on_card) - lib_fwd
        check(lib_bwd > 0, f"library backward time {lib_bwd}")
        fp32_sdpa_yardstick(card, shape, q, k, v, do, fwd_ms, dq_ms + dkv_ms)
        for name, m in out.items():
            m["library_ms"] = lib_fwd if name == names[0] else lib_bwd
            m["max_abs_err"] = errs[name]
            half = "forward" if name == names[0] \
                else "backward (dq, dk and dv together)"
            print(f"time {name} at {shape}, bf16 flash16, on {card}: kernel "
                  f"{m['ms']:.4f} ms ({m.pop('eager_ms'):.4f} ms a call "
                  f"enqueued eagerly), plain {m['plain_ms']:.4f} ms, bound "
                  f"{m['bound_ms']:.4f} ms by {m['bound_by']}, "
                  f"scaled_dot_product_attention {half} "
                  f"{m['library_ms']:.4f} ms (yardstick only)", flush=True)
    return out


def fp32_sdpa_yardstick(card, shape, q, k, v, do, fwd_ms, pair_ms) -> None:
    """The same function as the `flash` route (fp32 P on bf16 q, k, v):
    `scaled_dot_product_attention(is_causal=True)` on fp32 copies of q, k
    and v with both TF32 switches off, forward and backward (timed as
    forward + backward less the forward, over the same CUDA-graph replay),
    printed beside the `flash` route's forward and dQ + dK/dV pair on the
    same values, with the kernels that SDPA ran (its backend). A yardstick
    only."""
    from torch.profiler import ProfilerActivity, profile
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fq, fk, fv = (a.float().transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v))
    fg = do.float().transpose(1, 2)

    def fp32_step():
        lo = sdpa(fq, fk, fv, is_causal=True)
        torch.autograd.grad(lo, (fq, fk, fv), fg)

    on_card = dict(reps=10, inner=20, graph=True)
    with torch.no_grad():
        f32_fwd = cuda_ms(lambda: sdpa(fq, fk, fv, is_causal=True),
                          **on_card)
    f32_bwd = cuda_ms(fp32_step, **on_card) - f32_fwd
    check(f32_bwd > 0, f"fp32 SDPA backward time {f32_bwd}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):  # the trace may miss the first call's first kernel
            fp32_step()
        torch.cuda.synchronize()
    ran = sorted({ev.key.split("(")[0] for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA})
    print(f"time at {shape}, the `flash` function (fp32 P) on {card}: "
          f"scaled_dot_product_attention on fp32 copies of q, k, v, TF32 "
          f"off, forward {f32_fwd:.4f} ms, backward (dq, dk and dv) "
          f"{f32_bwd:.4f} ms, against the `flash` route's forward "
          f"{fwd_ms:.4f} ms and "
          f"dQ + dK/dV pair {pair_ms:.4f} ms on the same values; SDPA ran "
          f"{'; '.join(name[:80] for name in ran)}", flush=True)


# --------------------------------------------------------------- phase 12
LONG_SAMPLES, LONG_BATCH, LONG_STEPS = 163840, 16, 5


def transformer_slice(card: str) -> dict:
    """transformer_fast through the training CLI under each attn_impl and
    at the long context, then through `extract_features`; returns each
    attention kernel's launch count in the 10-step run that has it on its
    path (`flash16`: forward and one-pass backward; `flash`: dQ, dK/dV)."""
    layers = presets.transformer_fast().model.ar.num_layers
    on_path = {k: 1 for k in HEADS_KERNELS}
    counts = {}
    for impl, kernels in ATTN_ON_PATH.items():
        extra = [] if impl == "xla" else ["--set",
                                          f"model.ar.attn_impl={impl}"]
        run = train_cli_run(f"attn_impl={impl}", "transformer_fast", extra,
                            TRAIN_STEPS,
                            {**on_path, **{k: layers for k in kernels}})
        # each kernel's count from the first run that has it on its path
        counts.update({k: run[k] for k in kernels if k not in counts})
    with tempfile.TemporaryDirectory() as corpus:
        # the CLI's own synthetic files hold 4 s, a long snippet 10.24 s
        generate_synthetic_corpus(corpus, num_speakers=LONG_BATCH,
                                  files_per_speaker=2, seconds_per_file=12.0,
                                  seed=0)
        train_cli_run(
            f"long context, T = {LONG_SAMPLES // 160}", "transformer_fast",
            ["--data", corpus, "--snippet-samples", str(LONG_SAMPLES),
             "--batch-size", str(LONG_BATCH), "--set",
             "model.ar.attn_impl=flash16"], LONG_STEPS,
            {**on_path, **{k: layers for k in ATTN_ON_PATH["flash16"]}})

    cfg = apply_overrides(presets.transformer_fast(),
                          ["model.ar.attn_impl=flash16"])
    model = CPCModel(cfg.model, device="cuda",
                     generator=torch.Generator().manual_seed(0)).eval()
    window, bw, n_batches = cfg.data.snippet_samples, cfg.data.batch_size, 4
    n_samples = n_batches * bw * window
    wave = (np.random.default_rng(1).standard_normal(n_samples) * 0.1
            ).astype(np.float32)

    def extract():
        return extract_features(model, wave, window=window, batch_windows=bw,
                                normalize=cfg.data.normalize)

    for fn in COUNTED.values():
        fn.launches = 0
    t0 = time.perf_counter()
    z, c = extract()
    first_s = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in COUNTED.items() if fn.launches}
    want = {"flash_attention_forward": n_batches * layers}
    print(f"transformer extraction: launches {got} (expected {want})",
          flush=True)
    check(got == want, f"extraction launched {got}")
    N = n_samples // cfg.model.encoder.total_downsample
    check(z.shape == (N, cfg.model.encoder.d_enc)
          and c.shape == (N, cfg.model.ar.d_ar), f"{z.shape} {c.shape}")
    check(bool(np.isfinite(z).all() and np.isfinite(c).all()),
          "non-finite features")
    with torch.inference_mode():
        x0 = torch.from_numpy(wave[:bw * window].reshape(bw, window))
        z0 = model.encode(prepare_waveform(x0.cuda(), cfg.data.normalize))
        c_plain = plain_context(model.gar, z0).float().cpu().numpy()
    c_plain = c_plain.reshape(-1, cfg.model.ar.d_ar)
    c_err = float(np.abs(c[:len(c_plain)] - c_plain).max())
    # c is bf16 after the final LayerNorm, entries to about 4, where a bf16
    # ulp is 2**-6 = 0.016: P's rounding (see TRANSFORMER_STEP_TOL) moves an
    # entry by up to three of them (4.7e-2 measured)
    c_tol = 1e-1
    print(f"transformer extraction: c vs plain attention max abs err "
          f"{c_err:.3e} (tol {c_tol:.0e}), max |c| "
          f"{float(np.abs(c_plain).max()):.2f}", flush=True)
    check(c_err <= c_tol, f"transformer c error {c_err}")
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        extract()
        runs.append(time.perf_counter() - t0)
    audio_s = n_samples / cfg.data.sample_rate
    steady = statistics.median(runs)
    print(f"transformer extraction: {audio_s:.2f} audio-s of "
          f"transformer_fast (flash16, batch {bw}, bf16) on {card}: first "
          f"run {first_s:.3f} s, steady {steady:.3f} s (median of "
          f"{len(runs)}) = {audio_s / steady:.1f} audio-s/s", flush=True)
    return counts


# --------------------------------------------------------- phases 14 to 16
PYRAMID_FULL = ((512,) * 5, (10, 8, 4, 4, 4), (5, 4, 2, 2, 2))  # tpu_fast
PYRAMID_NARROW = ((32, 32, 48), (10, 8, 4), (5, 4, 2))
PYRAMID_CASES = [(PYRAMID_FULL, 64, 20480, torch.bfloat16),
                 (PYRAMID_FULL, 64, 20480, torch.float32),
                 (PYRAMID_FULL, 16, 163840, torch.bfloat16),
                 (PYRAMID_NARROW, 3, 3205, torch.bfloat16),
                 (PYRAMID_NARROW, 3, 3205, torch.float32),
                 # lengths that fit no tile: T = 4000, 1000, 500, 250, 125
                 (PYRAMID_FULL, 2, 20000, torch.bfloat16),
                 # T = 4, 1, 1, 1, 1: layers 3-5 read a phase with no rows
                 (PYRAMID_FULL, 1, 20, torch.bfloat16)]
# the two full-width shapes timed in bf16: tpu_fast, and its long snippet
PYRAMID_TIMED = [(64, 20480), (16, 163840)]
# z relative to max(1, max |plain|). fp32 (TF32 off) differs by summation
# order over a contraction of up to 4 096 terms. In bf16 a layer's output
# lands one bf16 rounding (2**-8 of the entry) apart where its fp32 sum is
# near a rounding edge, and the layers after it carry that on: a few ulps of
# the largest entry.
PYRAMID_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PYRAMID_OVERRIDE = "model.encoder.use_pallas=true"


def pyramid_inputs(spec, B, S, dtype, seed):
    """Seeded x (B, S), weights (C_out, C_in, k) scaled to keep the
    activations' size through the ReLUs, and biases, on the GPU."""
    channels, kernels, strides = spec
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.from_numpy(a).to("cuda", dtype).contiguous()
    weights, biases, c_in = [], [], 1
    for ch, k in zip(channels, kernels):
        weights.append(dev(rng.standard_normal((ch, c_in, k))
                           * np.sqrt(2.0 / (c_in * k))))
        biases.append(dev(rng.standard_normal(ch) * 0.1))
        c_in = ch
    return dev(rng.standard_normal((B, S))), weights, biases, kernels, strides


def pyramid_flops(spec, B, S, layers=None) -> float:
    flops, c_in, t = 0.0, 1, S
    for i, (ch, k, s) in enumerate(zip(*spec)):
        t = -(-t // s)
        if layers is None or i in layers:
            flops += 2.0 * B * t * k * c_in * ch
        c_in = ch
    return flops


def pyramid_times_ms(spec, B, S, card: str) -> dict:
    """The bf16 forward at (B, S): the whole, each launch apart, the
    weights' repack apart, plain, the bound and the cuDNN chain."""
    args = pyramid_inputs(spec, B, S, torch.bfloat16, seed=60)
    x, weights, biases, kernels, strides = args
    packed = pack_weights(weights)
    route, launches = pyramid_launches(x, packed, biases, kernels, strides)
    inputs = [x]
    for fn in launches[:-1]:
        inputs.append(fn(inputs[-1]))
    z = launches[-1](inputs[-1])
    flops = pyramid_flops(spec, B, S)
    out = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: conv_pyramid_forward(*args)),
        "plain_ms": cuda_ms(lambda: conv_pyramid_reference(*args), reps=5),
        # the yardstick, used nowhere on the kernel's path: five F.conv1d
        # calls on cuDNN and the copy to (B, T, C)
        "library_ms": cuda_ms(lambda: conv_chain(*args).contiguous()),
        "repack_ms": cuda_ms(lambda: pack_weights(weights)),
        "launch_ms": [cuda_ms(lambda fn=fn, h=h: fn(h))
                      for fn, h in zip(launches, inputs)],
        **bound([x, *weights, *biases, z], flops)}
    split = ", ".join(
        f"layers {'+'.join(str(i + 1) for i in launch.layers)} {ms:.4f} ms "
        f"({pyramid_flops(spec, B, S, launch.layers) / ms / 1e9:.1f} "
        f"TFLOP/s)" for launch, ms in zip(route.launches, out["launch_ms"]))
    print(f"time conv_pyramid_forward at {(B, S)} bf16 ({route.route}) on "
          f"{card}: {out['ms']:.4f} ms with the weights' repack "
          f"({flops / out['ms'] / 1e9:.1f} TFLOP/s); {split}; the repack "
          f"(a copy a layer) {out['repack_ms']:.4f} ms; plain "
          f"{out['plain_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']}; the F.conv1d chain on cuDNN with its "
          f"transposes (yardstick only) {out['library_ms']:.4f} ms",
          flush=True)
    return out


def phase14_kernels(card: str) -> dict:
    """The conv pyramid forward against its plain version; returns
    {name: {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}}."""
    name = "conv_pyramid_forward"
    max_err = 0.0
    with torch.inference_mode():
        for n, (spec, B, S, dtype) in enumerate(PYRAMID_CASES):
            args = pyramid_inputs(spec, B, S, dtype, seed=60 + n)
            channels, kernels, strides = spec
            route = pyramid_route(kernels, strides, channels, B, S, dtype)
            want_route = "wgmma" if dtype == torch.bfloat16 else "simt"
            what = f"{spec[0]} x {(B, S)} {str(dtype)[6:]}"
            check(route.route == want_route, f"{what}: route {route.route}")
            z = conv_pyramid_forward(*args)
            again = conv_pyramid_forward(*args)
            want = conv_pyramid_reference(*args)
            torch.cuda.synchronize()
            check(z.dtype == dtype and z.shape == want.shape
                  and z.is_contiguous(), f"{what}: {z.dtype} {z.shape}")
            check(bool(torch.isfinite(z.float()).all()), f"{what}: non-finite")
            check(torch.equal(z, again), f"{what}: two runs differ")
            tol = PYRAMID_TOL[dtype]
            abs_err = (z.float() - want.float()).abs().max().item()
            err = rel_err(z, want)
            # where SAME padding must feed zeros, not relu(bias)
            edges = max(rel_err(z[:, :2], want[:, :2]),
                        rel_err(z[:, -2:], want[:, -2:]))
            max_err = max(max_err, abs_err)
            print(f"{name} ({route.route}, {len(route.launches)} launches) "
                  f"vs plain {what} -> {tuple(z.shape)}: max abs err "
                  f"{abs_err:.3e}, relative to max(1, max |plain|) {err:.3e}, "
                  f"the first and last two latents of each snippet "
                  f"{edges:.3e} (tol {tol:.0e}), max |plain| "
                  f"{want.float().abs().max().item():.2f}; two runs "
                  f"bit-identical", flush=True)
            check(err <= tol and edges <= tol,
                  f"{what}: error {err}, at the edges {edges} > {tol}")

        spec = PYRAMID_FULL
        times = [pyramid_times_ms(spec, B, S, card) for B, S in PYRAMID_TIMED]
        B, S = PYRAMID_TIMED[0]
        fp32 = pyramid_inputs(spec, B, S, torch.float32, seed=60)
        fp32_ms = cuda_ms(lambda: conv_pyramid_forward(*fp32), reps=5)
    print(f"time {name} at {(B, S)} fp32 on the SIMT pipe on {card}: "
          f"{fp32_ms:.4f} ms", flush=True)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return {name: {"max_abs_err": max_err,
                   **{k: times[0][k] for k in keys}}}


def pyramid_slice(card: str) -> dict:
    """`encoder.use_pallas` through `extract_features` and the training
    CLI at full width; returns the CLI run's launch counts."""
    cfg = apply_overrides(presets.tpu_fast(), [PYRAMID_OVERRIDE])
    model = CPCModel(cfg.model, device="cuda",
                     generator=torch.Generator().manual_seed(0)).eval()
    chain = CPCModel(presets.tpu_fast().model, device="cuda").eval()
    chain.load_state_dict(model.state_dict())  # one state_dict, both routes
    window, bw, n_batches = cfg.data.snippet_samples, cfg.data.batch_size, 4
    n_samples = n_batches * bw * window
    wave = (np.random.default_rng(1).standard_normal(n_samples) * 0.1
            ).astype(np.float32)

    def extract(m=model):
        return extract_features(m, wave, window=window, batch_windows=bw,
                                normalize=cfg.data.normalize)

    for fn in COUNTED.values():
        fn.launches = 0
    t0 = time.perf_counter()
    z, c = extract()
    first_s = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in COUNTED.items() if fn.launches}
    want = {"conv_pyramid_forward": n_batches,
            "gru_scan": n_batches * cfg.model.ar.num_layers}
    print(f"use_pallas extraction: launches {got} (expected {want})",
          flush=True)
    check(got == want, f"use_pallas extraction launched {got}")
    N = n_samples // cfg.model.encoder.total_downsample
    check(z.shape == (N, cfg.model.encoder.d_enc)
          and c.shape == (N, cfg.model.ar.d_ar), f"{z.shape} {c.shape}")
    check(bool(np.isfinite(z).all() and np.isfinite(c).all()),
          "non-finite features")
    z_chain, c_chain = extract(chain)
    check(conv_pyramid_forward.launches == n_batches,
          "the default route launched the conv kernels")
    z_err = float(np.abs(z - z_chain).max() / max(1.0, np.abs(z_chain).max()))
    c_err = float(np.abs(c - c_chain).max())
    print(f"use_pallas extraction: z vs the cuDNN chain, relative to "
          f"max(1, max |z|) {z_err:.3e} (tol "
          f"{PYRAMID_TOL[torch.bfloat16]:.0e}, max |z| "
          f"{float(np.abs(z_chain).max()):.2f}); c max abs err {c_err:.3e} "
          f"(tol {TOL[torch.bfloat16]:.0e})", flush=True)
    check(z_err <= PYRAMID_TOL[torch.bfloat16], f"use_pallas z error {z_err}")
    check(c_err <= TOL[torch.bfloat16], f"use_pallas c error {c_err}")
    rates = {}
    for label, m in (("use_pallas", model), ("cuDNN chain", chain),
                     ("use_pallas again", model)):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            extract(m)
            runs.append(time.perf_counter() - t0)
        rates[label] = n_samples / cfg.data.sample_rate / statistics.median(
            runs)
    print(f"use_pallas extraction: {n_samples / cfg.data.sample_rate:.2f} "
          f"audio-s of tpu_fast (batch {bw}, bf16) on {card}: first run "
          f"{first_s:.3f} s; steady audio-s/s, medians of 3: "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()), flush=True)
    return train_cli_run(
        "encoder.use_pallas", "tpu_fast", ["--set", PYRAMID_OVERRIDE],
        TRAIN_STEPS, {k: 1 for k in GRU_KERNELS + HEADS_KERNELS
                      + ("conv_pyramid_forward",)})


# The use_pallas step, kernels against plain. Beyond STEP_TOL's differences
# the two encoders' z differ where a layer's fp32 sum lands near a bf16
# rounding edge (PYRAMID_TOL), and the GRU and the loss carry that on; the
# backward is the same cuDNN calls on the same values on both sides.
# Measured on an H100 80GB HBM3 at 700 W over two runs: loss 3.4e-7 and
# 5.6e-7, acc 1.3e-4 and 2.7e-4 (1 and 2 rows of 7 424), grad_norm 8.7e-6 and
# 2.1e-5, grads 3.8e-6 (conv0) and 3.1e-5 (conv4) absolute, 3.4e-3 and 4.2e-3
# of their largest entry.
PYRAMID_STEP_TOL = {"loss": 5e-6, "acc": 1e-3, "grad_norm": 1e-4,
                    "grad": 2e-4, "grad_of_max": 1e-2}


# --------------------------------------------------------- phases 17 to 19
# The front end on the card in fp32 (cuFFT, TF32 off) against the port's own
# function in float64 on the CPU, absolute on the log-power (values up to
# 12): the fp32 roundings of the rFFT and of the filterbank's and the
# constant-Q bank's sums. fp32 on the CPU lies 1.5e-5 from float64 at this
# width; a periodic Hann window in place of the symmetric one, 0.11.
FRONT_TOL = 5e-4
SCALES = ("log", "mel", "cqt")
SCALOGRAM_WATCHED = ("encoder.conv2d_0.weight", "encoder.proj.weight")
# The scalogram_fast step, kernels against plain: STEP_TOL, but for the
# watched gradients' absolute bound. Those of tpu_fast (wh, the heads'
# weight) leave the kernels and the folds in fp32; these two leave cuDNN's
# wgrad and cuBLAS in bf16 with entries up to 0.16, where one rounding flip
# (2**-8 of the entry) from the GRU's and the loss's fp32 summation order is
# up to 6e-4; grad_of_max holds them relative. Measured on an H100 80GB
# HBM3 at 700 W: loss 2.9e-7, acc 0, grad_norm 1.8e-6, grads 4.9e-4
# (conv2d_0) and 2.4e-4 (proj) absolute, 3.0e-3 and 2.6e-3 of their
# largest entry.
SCALOGRAM_STEP_TOL = {**STEP_TOL, "grad": 1e-3}


def scalogram_flops(enc, B: int, frames: int):
    """Forward FLOPs (Conv2d stack, proj) of ScalogramEncoder `enc` over B
    snippets of `frames` frames: 2 per multiply-add of each product."""
    t, f, c_in, convs = frames, enc.config.scalogram_n_bins, 1, 0.0
    for (kt, kf), ts, fs, ch in enc.geometry:
        t, f = -(-t // ts), -(-f // fs)
        convs += 2.0 * B * t * f * ch * c_in * kt * kf
        c_in = ch
    return convs, 2.0 * B * t * f * c_in * enc.config.d_enc


def phase17_front_end(card: str) -> None:
    """scalogram() at scalogram_fast's width for each scale against float64
    on the CPU; then the front end's, the Conv2d stack's, proj's and the
    encoder's times in bf16 at full width, with the achieved TFLOP/s."""
    cfg = presets.scalogram_fast()
    ec = cfg.model.encoder
    B, S = cfg.data.batch_size, cfg.data.snippet_samples
    kw = dict(n_fft=ec.scalogram_n_fft, hop=ec.scalogram_hop,
              n_bins=ec.scalogram_n_bins, fmin=ec.scalogram_fmin,
              fmax=ec.scalogram_fmax)
    x = torch.from_numpy((np.random.default_rng(17).standard_normal((B, S))
                          * 0.1).astype(np.float32)).cuda()
    x64 = x.cpu().double()
    shape = (B, S // ec.scalogram_hop, ec.scalogram_n_bins)
    front_ms = {}
    for scale in SCALES:
        got = scalogram(x, scale=scale, **kw)
        check(got.device == x.device and got.dtype == torch.float32
              and tuple(got.shape) == shape,
              f"scalogram {scale}: {got.device} {got.dtype} {got.shape}")
        check(bool(torch.isfinite(got).all()), f"scalogram {scale}: not "
              f"finite")
        err = (got.cpu().double() - scalogram(x64, scale=scale, **kw)
               ).abs().max().item()
        front_ms[scale] = cuda_ms(lambda: scalogram(x, scale=scale, **kw))
        print(f"front end ({scale}, {tuple(x.shape)} fp32 -> {shape}) on "
              f"{got.device}: max abs err vs float64 on the CPU {err:.3e} "
              f"(tol {FRONT_TOL:.0e}); {front_ms[scale]:.3f} ms on {card}",
              flush=True)
        check(err <= FRONT_TOL, f"scalogram {scale} error {err}")

    model = CPCModel(cfg.model, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    enc = model.encoder
    with torch.no_grad():
        h0 = scalogram(x, scale=ec.scalogram_scale, **kw)[:, None].to(
            enc.dtype)

        def stack():
            h = h0
            for i in range(len(enc.geometry)):
                h = enc._layer(h, i)
            return h

        h = stack()
        folded = h.permute(0, 2, 3, 1).reshape(B, h.shape[2], -1)
        ms = {"front end": front_ms[ec.scalogram_scale],
              "Conv2d stack": cuda_ms(stack),
              "proj": cuda_ms(lambda: enc.proj(folded)),
              "encoder forward": cuda_ms(lambda: enc(x))}
    g = torch.randn(B, h.shape[2], ec.d_enc, device=x.device,
                    dtype=enc.dtype)

    def forward_backward():
        enc.zero_grad(set_to_none=True)
        enc(x).backward(g)

    ms["encoder forward + backward"] = cuda_ms(forward_backward, reps=10)
    convs, proj = scalogram_flops(enc, B, shape[1])
    print(f"scalogram encoder ({ec.scalogram_scale}, bf16, batch {B} x {S}) "
          f"on {card}, CUDA-event medians: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f"; forward FLOPs: Conv2d stack {convs / 1e9:.1f} G = "
          f"{convs / ms['Conv2d stack'] / 1e9:.1f} TFLOP/s, proj "
          f"{proj / 1e9:.1f} G = {proj / ms['proj'] / 1e9:.1f} TFLOP/s "
          f"(a yardstick, not a gate)", flush=True)


def scalogram_slice(card: str) -> dict:
    """scalogram_fast through the training CLI on the music corpus, then
    `--extract` through the eval CLI from that workdir; returns the training
    run's launch counts."""
    cfg = presets.scalogram_fast()
    with tempfile.TemporaryDirectory() as workdir:
        counts = train_cli_run(
            "scalogram_fast", "scalogram_fast", ["--data", "synthetic-music"],
            TRAIN_STEPS, {k: 1 for k in GRU_KERNELS + HEADS_KERNELS},
            workdir=workdir)
        window, bw, n_batches = (cfg.data.snippet_samples,
                                 cfg.data.batch_size, 4)
        wav = os.path.join(workdir, "extract.wav")
        write_wav(wav, (np.random.default_rng(18).standard_normal(
            n_batches * bw * window) * 0.1).astype(np.float32),
            cfg.data.sample_rate)
        out = os.path.join(workdir, "features.npz")
        for fn in COUNTED.values():
            fn.launches = 0
        said = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            rc = eval_cli.main(["--extract", wav, "--workdir", workdir,
                                "--out", out])
        cli_s = time.perf_counter() - t0
        line = json.loads(said.getvalue().strip().splitlines()[-1])
        got = {k: fn.launches for k, fn in COUNTED.items() if fn.launches}
        # the eval CLI extracts 32 windows a batch
        want = {"gru_scan": n_batches * bw // 32 * cfg.model.ar.num_layers}
        print(f"scalogram extraction through cpc_tpu_torch.eval.cli.main in "
              f"{cli_s:.2f} s (model load and first run): {line}; launches "
              f"{got} (expected {want})", flush=True)
        check(rc == 0 and line["checkpoint_step"] == TRAIN_STEPS,
              f"eval cli: rc {rc}, {line}")
        check(got == want, f"scalogram extraction launched {got}")
        wave, _ = decode_mono(wav, cfg.data.sample_rate)
        with np.load(out) as f:
            z, c = f["z"], f["c"]
        N = len(wave) // cfg.model.encoder.total_downsample
        check(z.shape == (N, cfg.model.encoder.d_enc)
              and c.shape == (N, cfg.model.ar.d_ar), f"{z.shape} {c.shape}")
        check(bool(np.isfinite(z).all() and np.isfinite(c).all()),
              "non-finite scalogram features")
        model = CPCModel(cfg.model, device="cuda")
        model.load_state_dict(CheckpointManager(os.path.join(
            workdir, cfg.train.checkpoint_dir)).restore_latest(
                map_location="cuda")["model"])
        model.eval()
    # c of the first 64 windows with the plain recurrence
    with torch.inference_mode():
        x0 = torch.from_numpy(wave[:bw * window].reshape(bw, window))
        h = model.encode(prepare_waveform(x0.cuda(), cfg.data.normalize))
        for layer in model.gar.layers():
            h = gru_scan_reference(*layer.scan_inputs(h, None)).transpose(0, 1)
    c_plain = h.float().cpu().numpy().reshape(-1, cfg.model.ar.d_ar)
    c_err = float(np.abs(c[:len(c_plain)] - c_plain).max())
    print(f"scalogram extraction: c vs plain recurrence max abs err "
          f"{c_err:.3e} (tol {TOL[torch.bfloat16]:.0e})", flush=True)
    check(c_err <= TOL[torch.bfloat16], f"scalogram c error {c_err}")
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        extract_features(model, wave, window=window, batch_windows=bw,
                         normalize=cfg.data.normalize)
        runs.append(time.perf_counter() - t0)
    audio_s = len(wave) / cfg.data.sample_rate
    print(f"scalogram extraction: {audio_s:.2f} audio-s of scalogram_fast "
          f"(batch {bw}, bf16, trained weights) on {card}: steady "
          f"{statistics.median(runs):.3f} s (median of 3) = "
          f"{audio_s / statistics.median(runs):.1f} audio-s/s", flush=True)
    return counts


# ------------------------------------------------------------ phases 20-22
# the keys of the JAX package's battery row (cpc_tpu/eval/battery.py, and
# the eval CLI's checkpoint_step), held against it on the CPU by
# tests/test_torch_port_probes.py
BATTERY_KEYS = [
    "checkpoint_step", "speaker_file_acc", "speaker_file_acc_std",
    "speaker_file_last_acc", "speaker_file_last_acc_std",
    "speaker_file_max_acc", "speaker_file_max_acc_std",
    "speaker_file_eval_n", "speaker_acc", "speaker_acc_std",
    "speaker_eval_n", "speaker_classes", "speaker_utt_acc",
    "speaker_utt_eval_n", "phone_file_acc", "phone_file_acc_std",
    "phone_snip_acc", "phone_eval_n", "phone_classes"]
BATTERY_PROBE_SEEDS = 3  # the CLI's default
PROBE_BATCH = PROBE_SHAPE[1]  # snippets a batch of the probes' extraction


def eval_cli_run(argv) -> tuple:
    """`cpc_tpu_torch.eval.cli.main(argv)` with every count set to 0 just
    before; returns (its last JSON line, the launches, wall seconds)."""
    for fn in COUNTED.values():
        fn.launches = 0
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        rc = eval_cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"eval cli {argv} returned {rc}")
    line = json.loads(said.getvalue().strip().splitlines()[-1])
    return line, {k: fn.launches for k, fn in COUNTED.items()
                  if fn.launches}, wall


def unit_interval(x) -> bool:
    return isinstance(x, float) and math.isfinite(x) and 0.0 <= x <= 1.0


def workdir_model(workdir: str):
    """The model a workdir holds, on the card, as the eval CLI loads it."""
    with open(os.path.join(workdir, "config.json")) as f:
        cfg = from_dict(json.load(f))
    model = CPCModel(cfg.model)
    check(load_weights(model, workdir, cfg) == TRAIN_STEPS,
          f"{workdir}: no step_{TRAIN_STEPS} checkpoint")
    return cfg, model.to("cuda").eval()


def phase20_probes(card: str, workdir: str) -> None:
    """tpu_fast trained 10 steps through the training CLI into `workdir`,
    then the battery (twice) and `--probe both` through the eval CLI on the
    card: keys, accuracies in [0, 1], the GRU kernel once a batch of the
    extraction, the same row twice; then the extraction's rate, the fit's
    time at the phone probe's shape and the battery's wall time."""
    train_cli_run("probes", "tpu_fast", [], TRAIN_STEPS,
                  {k: 1 for k in GRU_KERNELS + HEADS_KERNELS},
                  workdir=workdir)
    cfg, model = workdir_model(workdir)
    ds = ProbeDataset(os.path.join(workdir, "synthetic_corpus"),
                      cfg.data.snippet_samples, cfg.data.snippet_samples,
                      cfg.data.sample_rate)
    layers = cfg.model.ar.num_layers

    def batches(n):
        return -(-min(len(ds), n) // PROBE_BATCH)

    rows, walls = [], []
    for _ in range(2):
        row, got, wall = eval_cli_run(["--workdir", workdir, "--battery",
                                       "--probe-seeds",
                                       str(BATTERY_PROBE_SEEDS)])
        want = {"gru_scan": (batches(len(ds)) + batches(200)) * layers}
        check(got == want, f"battery launched {got}, expected {want}")
        rows.append(row)
        walls.append(wall)
    row = rows[0]
    check(list(row) == BATTERY_KEYS, f"battery keys {list(row)}")
    check(row["checkpoint_step"] == TRAIN_STEPS, f"battery row {row}")
    check(all(unit_interval(v) for k, v in row.items()
              if k.endswith(("_acc", "_acc_std"))),
          f"battery accuracies out of [0, 1]: {row}")
    check(rows[1] == row, f"the battery differs between two runs: {rows}")
    line, got, wall = eval_cli_run(["--workdir", workdir, "--probe", "both"])
    want = {"gru_scan": 2 * batches(512) * layers}
    check(got == want, f"--probe both launched {got}, expected {want}")
    check(list(line) == ["checkpoint_step", "feature", "speaker_probe",
                         "phone_probe"], f"--probe both keys {list(line)}")
    check(all(unit_interval(line[k]["accuracy"])
              for k in ("speaker_probe", "phone_probe")), f"{line}")
    # the battery's fits (battery.py): per seed 4 speaker fits (file split
    # of mean, last and max pooling; snippet split) and 1 phone fit (file
    # split), then 1 utterance and 1 phone snippet-split fit
    seeds = BATTERY_PROBE_SEEDS
    spk_fits, ph_fits = 4 * seeds + 1, seeds + 1
    print(f"probes: battery through cpc_tpu_torch.eval.cli.main in "
          f"{walls[0]:.2f} and {walls[1]:.2f} s (model load, {len(ds)} + 200 "
          f"snippets' extraction, {spk_fits} speaker and {ph_fits} phone fits "
          f"of 400 steps at --probe-seeds {seeds}; identical rows): "
          f"{json.dumps(row)}; --probe both in {wall:.2f} s: "
          f"{json.dumps(line)}; launches as expected", flush=True)

    sweeps = []
    for _ in range(3):
        t0 = time.perf_counter()
        frames, spk, spk_files = probes.extract_speaker_frame_features(
            model, ds, max_snippets=len(ds))
        sweeps.append(time.perf_counter() - t0)
    audio_s = len(ds) * cfg.data.snippet_samples / cfg.data.sample_rate
    pooled = probes.pool_time(frames, "mean")
    tr, _ = probes._split_items(len(pooled), spk_files, "file", 0.25, 0)
    spk_ms, spk_shape = fit_ms(pooled[tr], spk[tr], ds.num_speakers)
    t0 = time.perf_counter()
    feats, lab, files = probes.extract_phone_frame_features(
        model, ds, feature="z", max_snippets=200)
    ph_sweep = time.perf_counter() - t0
    N, T, d = feats.shape
    tr, _ = probes._split_items(N, files, "snippet", 0.25, 0)
    ph_ms, ph_shape = fit_ms(feats[tr].reshape(-1, d), lab[tr].reshape(-1),
                             int(lab.max()) + 1)
    sweep = statistics.median(sweeps)
    parts = sweep + ph_sweep + (spk_fits * spk_ms + ph_fits * ph_ms) / 1e3
    print(f"probes on {card}: extraction of {len(ds)} snippets "
          f"({audio_s:.2f} audio-s, bf16, batches of {PROBE_BATCH}) "
          f"{sweep:.3f} s (median of 3) = {audio_s / sweep:.1f} audio-s/s, "
          f"of the phone probe's 200 {ph_sweep:.3f} s; the fit, 400 Adam "
          f"steps fp32 (median of 3), at the speaker probe's file-split "
          f"train set {spk_shape}: {spk_ms:.1f} ms = {spk_ms / 400:.3f} ms a "
          f"step, at the phone probe's snippet-split train frames "
          f"{ph_shape}: {ph_ms:.1f} ms = {ph_ms / 400:.3f} ms a step; the "
          f"battery's extraction and fits from these parts: {parts:.2f} s "
          f"of its {min(walls):.2f} s wall", flush=True)


def fit_ms(x: np.ndarray, y: np.ndarray, num_classes: int) -> tuple:
    """Median ms of 3 runs of `_fit_linear`'s 400 steps on (x, y) on the
    card, and x's shape."""
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()
    y = torch.from_numpy(np.asarray(y, np.int64)).cuda()
    w0, b0 = probes._init_linear(x.shape[1], num_classes, 0)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probes._fit_linear(x, y, w0, b0, steps=400, lr=1e-2)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs), tuple(x.shape)


# (T, B, H) of the streams' pushes, fp32 with a carried h0: a few latents
# or a second's 100 at B = 1, and a few or a second's at phase 21's 8 streams
STREAM_GRU_SHAPES = [(1, 1, 256), (3, 1, 256), (100, 1, 256), (6, 8, 256),
                     (100, 8, 256)]
STREAM_SECONDS = 10
STREAM_CHUNKS = (16000, 2560, 1001)  # a multiple of the hop, and two not
# stream against offline VALID forward, as |a - b| <= atol + rtol |b|: the
# JAX test's tolerances (tests/test_streaming.py)
STREAM_TOL = {"z": (1e-5, 1e-5), "c": (1e-5, 2e-5)}


def stream_kernel_checks(card: str) -> None:
    """`gru_scan` against its plain version at the shapes a stream gives it
    (fp32, B = 1 or 8, a few latents a push, a nonzero h0), on the resident
    route, twice for bit-identical results; then its times there."""
    with torch.inference_mode():
        for n, (T, B, H) in enumerate(STREAM_GRU_SHAPES):
            route = gru_route(B, H, torch.float32)
            check(route == "resident", f"{(T, B, H)} takes {route}")
            args = gru_inputs(T, B, H, torch.float32, seed=40 + n)
            out, again = gru_scan(*args), gru_scan(*args)
            ref = gru_scan_reference(*args)
            torch.cuda.synchronize()
            check(torch.equal(out, again),
                  f"gru_scan {(T, B, H)} differs between two runs")
            err = (out - ref).abs().max().item()
            check(err <= TOL[torch.float32],
                  f"gru_scan {(T, B, H)} error {err}")
            ms = cuda_ms(lambda: gru_scan(*args), reps=10, inner=20,
                         graph=True)
            plain_ms = cuda_ms(lambda: gru_scan_reference(*args), reps=5)
            cudnn, x, h0 = cudnn_gru(T, B, H, torch.float32)
            lib_ms = cuda_ms(lambda: cudnn(x, h0), reps=10, inner=20,
                             graph=True)
            bnd = bound([*args, out], 2 * T * B * H * 3 * H, torch.float32)
            print(f"gru_scan vs plain {(T, B, H)} fp32 (resident route, "
                  f"stream shape): max abs err {err:.3e} (tol "
                  f"{TOL[torch.float32]:.0e}); two runs bit-identical; on "
                  f"{card}: kernel {ms:.4f} ms = {ms / T * 1e3:.3f} us a "
                  f"step (CUDA-graph replay), plain {plain_ms:.4f} ms, bound "
                  f"{bnd['bound_ms']:.6f} ms by {bnd['bound_by']}, "
                  f"torch.nn.GRU fp32 (cuDNN, TF32 off; yardstick only, it "
                  f"also does the input projection) {lib_ms:.4f} ms",
                  flush=True)


def held(name: str, got, want) -> float:
    """max |got - want|, checked against STREAM_TOL[name]."""
    rtol, atol = STREAM_TOL[name]
    err = float(np.abs(got - want).max())
    check(got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}")
    check(bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want))),
          f"stream {name} off the offline forward by {err:.3e}")
    return err


def offline_valid(pm, waves):
    """(z, c) of the portable model's offline VALID forward, fp32 (TF32
    off), of `waves` (B, L)."""
    with torch.no_grad(), fp32_exact():
        z = pm.encode(torch.from_numpy(waves).cuda())
        c = pm.gar(z)
    return z.cpu().numpy(), c.cpu().numpy()


def feed(ex, waves, chunk):
    """Pushes `waves` ((L,) or (B, L)) `chunk` samples at a time, every count
    set to 0 just before; returns (z, c, seconds of each push, launches,
    pushes that emitted latents)."""
    for fn in COUNTED.values():
        fn.launches = 0
    zs, cs, secs, emitted = [], [], [], 0
    for a in range(0, waves.shape[-1], chunk):
        t0 = time.perf_counter()
        z, c = ex.push(waves[..., a:a + chunk])
        secs.append(time.perf_counter() - t0)
        emitted += z.shape[-2] > 0
        zs.append(z)
        cs.append(c)
    counts = {k: fn.launches for k, fn in COUNTED.items() if fn.launches}
    return (np.concatenate(zs, axis=-2), np.concatenate(cs, axis=-2), secs,
            counts, emitted)


def phase21_streams(card: str) -> None:
    """Row 1 at the streaming shapes, then StreamingExtractor at full width
    (tpu_fast's GRU, transformer_fast) with torch's default TF32 settings
    in force (cuDNN may take TF32): chunks of 16 000, 2 560 and 1 001
    samples against the offline VALID forward, 8 streams with one
    reset_stream, launches, push times and decode_step's time."""
    stream_kernel_checks(card)
    kept = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True      # torch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name in ("tpu_fast", "transformer_fast"):
            stream_model(card, name)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = kept


def stream_model(card: str, name: str) -> None:
    cfg = presets.by_name(name)
    model = CPCModel(cfg.model, device="cuda",
                     generator=torch.Generator().manual_seed(0)).eval()
    pm = portable_stream_model(cfg.model, device="cuda")
    pm.load_state_dict(model.state_dict())
    pm.eval()
    rate = cfg.data.sample_rate
    L = STREAM_SECONDS * rate
    wave = (np.random.default_rng(21).standard_normal(L) * 0.1
            ).astype(np.float32)
    z_off, c_off = offline_valid(pm, wave[None])
    with torch.no_grad():   # the same forward with the TF32 it would take
        z_tf32 = pm.encode(torch.from_numpy(wave[None]).cuda()).cpu().numpy()
    print(f"stream {name}: the offline forward under torch's default TF32 "
          f"settings is {np.abs(z_tf32 - z_off).max():.3e} from fp32 on z "
          f"(what the extractor's fp32_exact keeps out)", flush=True)
    gru = cfg.model.ar.kind == "gru"
    layers = cfg.model.ar.num_layers
    for chunk in STREAM_CHUNKS:
        ex = StreamingExtractor(model)
        z, c, secs, counts, emitted = feed(ex, wave, chunk)
        want = {"gru_scan": emitted * layers} if gru else {}
        check(counts == want, f"{name} stream launched {counts}, expected "
              f"{want}")
        ez, ec = held("z", z, z_off[0]), held("c", c, c_off[0])
        line = (f"stream {name} chunks of {chunk}: {len(z)} latents, z "
                f"{ez:.3e}, c {ec:.3e} from the offline VALID forward (tol "
                f"rtol 1e-5 + atol 1e-5 / 2e-5); launches {counts}")
        if chunk == rate:
            steady = statistics.median(secs[1:]) * 1e3
            line += (f"; on {card}: first push {secs[0] * 1e3:.2f} ms, then "
                     f"{steady:.2f} ms a push of {chunk} samples (median of "
                     f"{len(secs) - 1}) = real-time factor "
                     f"{chunk / rate / steady * 1e3:.1f} audio-s/s")
        print(line, flush=True)

    # 8 lockstep streams, stream 3 recycled after 5 pushes
    B, chunk, at = 8, rate, 5 * rate
    waves = (np.random.default_rng(22).standard_normal((B, L)) * 0.1
             ).astype(np.float32)
    fresh = (np.random.default_rng(23).standard_normal(L - at) * 0.1
             ).astype(np.float32)
    ex = StreamingExtractor(model, n_streams=B)
    z1, c1, s1, n1, e1 = feed(ex, waves[:, :at], chunk)
    resid = ex.pending_samples
    ex.reset_stream(3)
    later = waves[:, at:].copy()
    later[3] = fresh
    z2, c2, s2, n2, e2 = feed(ex, later, chunk)
    want = {"gru_scan": e2 * layers} if gru else {}
    check(n2 == want, f"{name} 8 streams launched {n2}, expected {want}")
    zo, co = offline_valid(pm, waves)
    keep = [i for i in range(B) if i != 3]
    z_all, c_all = np.concatenate([z1, z2], 1), np.concatenate([c1, c2], 1)
    ez = held("z", z_all[keep], zo[keep])
    ec = held("c", c_all[keep], co[keep])
    zr, cr = offline_valid(pm, np.concatenate(
        [np.zeros(resid, np.float32), fresh])[None])
    er = max(held("z", z2[3], zr[0]), held("c", c2[3], cr[0]))
    secs = s1[1:] + s2
    steady = statistics.median(secs) * 1e3
    print(f"stream {name} x {B} streams, stream 3 reset after {at} samples: "
          f"z {ez:.3e}, c {ec:.3e} from the offline forward, the reset "
          f"stream {er:.3e} from zeros({resid}) + its new audio; on {card}: "
          f"first push {s1[0] * 1e3:.2f} ms, then {steady:.2f} ms a push of "
          f"{B} x {chunk} samples (median of {len(secs)}) = real-time "
          f"factor {B * chunk / rate / steady * 1e3:.1f} audio-s/s",
          flush=True)

    if not gru:   # decode_step alone, one latent a call at B = 1
        tr = carry_decode_model(cfg.model.encoder.d_enc, pm.config.ar)
        tr.load_state_dict(pm.gar.state_dict())
        tr.to("cuda").eval()
        carry = decode_carry(cfg.model.ar, 1, device="cuda")
        z_t = torch.randn(1, cfg.model.encoder.d_enc, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
        steps = 200
        with torch.no_grad(), fp32_exact():
            for _ in range(10):
                tr.decode_step(z_t, carry)
            carry = decode_carry(cfg.model.ar, 1, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                _, carry = tr.decode_step(z_t, carry)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        print(f"decode_step of {name} (d_ar {cfg.model.ar.d_ar}, "
              f"{layers} layers, KV cache of {cfg.model.ar.max_len}, fp32) "
              f"on {card}: {ms:.3f} ms a latent at B = 1 ({steps} latents, "
              f"host clock with a CUDA sync)", flush=True)


def phase22_serve(card: str, workdir: str) -> None:
    """`cpc_tpu_torch.serve.main` on phase 20's workdir, i16 stdin, --emit
    zc: the header's geometry, the frame count and summary, the frames bit
    for bit against a StreamingExtractor fed the same chunks, launches,
    and the server's rate."""
    cfg, model = workdir_model(workdir)
    rate, chunk, seconds = cfg.data.sample_rate, 16000, 30
    q = np.clip(np.random.default_rng(24).standard_normal(seconds * rate)
                * 3000, -32768, 32767).astype("<i2")
    out, err = io.BytesIO(), StampedText()
    for fn in COUNTED.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rc = serve.main(["--workdir", workdir, "--emit", "zc", "--in-format",
                     "i16"], stdin=io.BytesIO(q.tobytes()), stdout=out,
                    stderr=err)
    wall = time.perf_counter() - t0
    # the load ends where the header is written, the serve loop where the
    # summary is
    load_s = err.stamp('"frame_dim"') - t0
    loop_s = err.stamp('"frames"') - err.stamp('"frame_dim"')
    counts = {k: fn.launches for k, fn in COUNTED.items() if fn.launches}
    check(rc == 0, f"serve returned {rc}")
    lines = [json.loads(x) for x in err.getvalue().splitlines()]
    header, summary = lines[0], lines[-1]
    d_enc, d_ar = cfg.model.encoder.d_enc, cfg.model.ar.d_ar
    check(header == {"emit": "zc", "frame_dim": d_enc + d_ar,
                     "frame_stride_samples": 160,
                     "receptive_field_samples": 465, "d_enc": d_enc,
                     "d_ar": d_ar}, f"serve header {header}")
    n = (len(q) - 465) // 160 + 1
    check(summary == {"frames": n, "dropped_tail_samples": len(q) - n * 160,
                      "dropped_partial_bytes": 0}, f"serve summary {summary}")
    frames = np.frombuffer(out.getvalue(), "<f4").reshape(-1, d_enc + d_ar)
    pushes = -(-len(q) // chunk)
    check(counts == {"gru_scan": pushes * cfg.model.ar.num_layers},
          f"serve launched {counts}")
    ex = StreamingExtractor(model)
    deq = q.astype(np.float32) / 32768.0
    z, c, _, _, _ = feed(ex, deq, chunk)
    check(frames.shape == (n, d_enc + d_ar)
          and np.array_equal(frames, np.concatenate([z, c], 1)),
          "served frames differ from the extractor's")
    check(bool(np.isfinite(frames).all()), "non-finite served frames")
    print(f"serve: cpc_tpu_torch.serve.main --workdir (tpu_fast, step "
          f"{TRAIN_STEPS}) --emit zc --in-format i16, {seconds} audio-s in "
          f"chunks of {chunk}: header {json.dumps(header)}, summary "
          f"{json.dumps(summary)}, frames bit-equal to the extractor's, "
          f"launches {counts}; on {card}: the serve loop (header to "
          f"summary: {-(-len(q) // chunk)} chunks read, pushed and written) "
          f"{loop_s * 1e3:.2f} ms = {seconds / loop_s:.1f} audio-s/s; "
          f"start-up (arguments, config, checkpoint load, model to the "
          f"card) {load_s * 1e3:.1f} ms; whole call {wall * 1e3:.1f} ms",
          flush=True)


class StampedText(io.StringIO):
    """A text stream that keeps the host clock at each write."""

    def __init__(self):
        super().__init__()
        self.writes = []

    def write(self, text: str) -> int:
        self.writes.append((time.perf_counter(), text))
        return super().write(text)

    def stamp(self, key: str) -> float:
        """The time of the first write that holds `key`."""
        return next(t for t, text in self.writes if key in text)


def main() -> None:
    # 1. device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false; "
          "this script needs one CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"gpu: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{_build.library_path().name}", flush=True)

    # 3. kernel vs plain, on the same CUDA tensors
    gru_fwd = phase3_gru(card)

    # 4. the slice: tpu_fast at full width, random weights from a seed
    cfg = presets.tpu_fast()
    model = CPCModel(cfg.model, device="cuda",
                     generator=torch.Generator().manual_seed(0)).eval()
    window, bw, n_batches = cfg.data.snippet_samples, cfg.data.batch_size, 4
    n_samples = n_batches * bw * window
    wave = (np.random.default_rng(1).standard_normal(n_samples) * 0.1
            ).astype(np.float32)

    def extract():
        return extract_features(model, wave, window=window, batch_windows=bw,
                                normalize=cfg.data.normalize)

    gru_scan.launches = 0
    t0 = time.perf_counter()
    z, c = extract()
    first_s = time.perf_counter() - t0
    launches = gru_scan.launches
    expected = n_batches * cfg.model.ar.num_layers
    print(f"slice: gru_scan.launches {launches} (expected {expected})",
          flush=True)
    check(launches == expected, f"gru_scan launched {launches} times")
    N = n_samples // cfg.model.encoder.total_downsample
    check(z.shape == (N, cfg.model.encoder.d_enc)
          and c.shape == (N, cfg.model.ar.d_ar), f"{z.shape} {c.shape}")
    check(bool(np.isfinite(z).all() and np.isfinite(c).all()),
          "non-finite features")

    # c of the first batch against the same model with the plain recurrence
    with torch.inference_mode():
        x0 = torch.from_numpy(wave[:bw * window].reshape(bw, window))
        h = model.encode(prepare_waveform(x0.cuda(), cfg.data.normalize))
        for layer in model.gar.layers():
            h = gru_scan_reference(*layer.scan_inputs(h, None)).transpose(0, 1)
    c_plain = h.float().cpu().numpy().reshape(-1, cfg.model.ar.d_ar)
    c_err = float(np.abs(c[:len(c_plain)] - c_plain).max())
    print(f"slice: c vs plain recurrence max abs err {c_err:.3e} "
          f"(tol {TOL[torch.bfloat16]:.0e})", flush=True)
    check(c_err <= TOL[torch.bfloat16], f"slice c error {c_err}")

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        extract()
        runs.append(time.perf_counter() - t0)
    audio_s = n_samples / cfg.data.sample_rate
    steady = statistics.median(runs)
    print(f"slice: {audio_s:.2f} audio-s of tpu_fast extraction "
          f"(batch {bw}, bf16) on {card}: first run {first_s:.3f} s, "
          f"steady {steady:.3f} s (median of {len(runs)}) = "
          f"{audio_s / steady:.1f} audio-s/s", flush=True)

    # 5-7. the training slice
    measured = {"gru_scan": gru_fwd, **phase5_kernels(card)}
    counts = train_through_cli("fused")
    step_vs_plain(card, "fused", ("gar.layer0.wh", "prediction_heads.weight"))

    # 8-10. the other two loss paths
    measured.update(phase8_kernels(card))
    last_encoder = f"encoder.conv{len(cfg.model.encoder.channels) - 1}.weight"
    for path in ("all_steps", "fuse_heads=false"):
        run = train_through_cli(path)
        counts.update({name: run[name] for name in LOSS_PATHS[path][1]})
    for path in ("all_steps", "fuse_heads=false"):
        step_vs_plain(card, path, ("prediction_heads.weight", last_encoder))

    # 11-13. the transformer gar and its attention kernels
    measured.update(phase11_kernels(card))
    run = transformer_slice(card)
    counts.update({name: run[name] for name in ATTN_KERNELS})
    watched = ("gar.block0.attn.query.weight", "gar.in_proj.weight")
    for impl in ("flash16", "flash"):
        step_vs_plain(card, f"attn_impl={impl}", watched, "transformer_fast",
                      [f"model.ar.attn_impl={impl}"], TRANSFORMER_STEP_TOL)
    step_vs_plain(card, "attn_impl=xla", watched, "transformer_fast", [],
                  compare=False)

    # 14-16. the conv pyramid kernels behind encoder.use_pallas
    measured.update(phase14_kernels(card))
    counts["conv_pyramid_forward"] = pyramid_slice(card)[
        "conv_pyramid_forward"]
    step_vs_plain(card, "encoder.use_pallas",
                  ("encoder.conv0.weight", last_encoder), "tpu_fast",
                  [PYRAMID_OVERRIDE], PYRAMID_STEP_TOL)

    # 17-19. the scalogram family: its front end and Conv2d encoder under
    # the GRU and fused heads kernels
    phase17_front_end(card)
    scalogram_slice(card)
    step_vs_plain(card, "scalogram", SCALOGRAM_WATCHED, "scalogram_fast", [],
                  SCALOGRAM_STEP_TOL)

    # 20-22. evaluation and serving: the probes and the battery, streams,
    # the feature server
    with tempfile.TemporaryDirectory() as workdir:
        phase20_probes(card, workdir)
        phase21_streams(card)
        phase22_serve(card, workdir)

    sources = {
        "gru_scan": ("gru_scan.cu", "cpc_tpu/ops/gru_pallas.py:57"),
        "gru_scan_backward": ("gru_scan.cu", "cpc_tpu/ops/gru_pallas.py:82"),
        "heads_nll_forward": ("infonce_fused.cu",
                              "cpc_tpu/ops/infonce_fused.py:70"),
        "heads_nll_backward": ("infonce_fused.cu",
                               "cpc_tpu/ops/infonce_fused.py:97"),
        "same_step_nll_forward": ("infonce_same_step.cu",
                                  "cpc_tpu/ops/infonce_pallas.py:103"),
        "same_step_nll_backward": ("infonce_same_step.cu",
                                   "cpc_tpu/ops/infonce_pallas.py:124"),
        "allsteps_nll_forward": ("infonce_allsteps.cu",
                                 "cpc_tpu/ops/infonce_allsteps_pallas.py:55"),
        "allsteps_nll_backward": (
            "infonce_allsteps.cu",
            "cpc_tpu/ops/infonce_allsteps_pallas.py:100"),
        "flash_attention_forward": ("flash_attention.cu",
                                    "cpc_tpu/ops/attention_pallas.py:65"),
        "flash_attention_backward": ("flash_attention.cu",
                                     "cpc_tpu/ops/attention_pallas.py:118"),
        "flash_attention_dq": ("flash_attention.cu",
                               "cpc_tpu/ops/attention_pallas.py:118"),
        "flash_attention_dkv": ("flash_attention.cu",
                                "cpc_tpu/ops/attention_pallas.py:148"),
        "conv_pyramid_forward": ("conv_pyramid.cu",
                                 "cpc_tpu/ops/conv_pallas.py:99")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"cpc_tpu_torch/csrc/{src}", "replaces": tpu,
        "launches": counts[name], **{k: measured[name][k] for k in keys}}
        for name, (src, tpu) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
