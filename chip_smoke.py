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
   (header to summary) and the start-up (the load) apart;
23. data parallelism (`dp_global_negatives`, global batch 64) on the one
   card: (a) a one-rank NCCL group (`multihost.initialize` on 127.0.0.1)
   runs a full-width step bit-equal to the `tpu_fast` step from the same
   weights (metrics, every gradient, the parameters after the update; cuDNN
   deterministic), then both steps' times and the gather's and the
   gradients' average's alone; (b) two ranks sharing cuda:0 through gloo,
   asked for by name (this script again as `--dp-rank R`, killed together
   if one fails), one step of each loss path (fused, fuse_heads=false,
   all_steps; the fused path in fp32 too) on their 32 rows each against one
   process's step on the concatenated 64 through the same kernels: loss,
   per-k accuracy, grad_norm and phase 7's two watched gradients at phase
   7's tolerances (grad_norm at 1e-4: each rank rounds its bf16 dz of the
   pool before the ranks' sum), the ranks' parameters bit-equal, the
   path's loss kernels and the GRU's once a rank and the others never;
   (c) the kernels at the per-rank
   shapes (heads (128, 32, 64, 12, 512), same-step and all-steps
   (32, 128, 64, 12, 512), shift 32; the GRU backward at (128, 32, 256))
   against their plain versions on phases 5 and 8's routes and
   tolerances, timed beside tpu_fast's; (d) `cpc_tpu_torch.train.cli.main
   --coordinator 127.0.0.1:P --num-processes 1 --process-id 0` for 10
   steps (the launches counted), then 5 + 5 with `--resume`, bit-equal
   under the CLI's own cuDNN settings (torch's defaults: nothing forced);
   and `python -m cpc_tpu_torch.train --num-processes 2` on the one card
   under `--device cuda`, which must exit non-zero naming the cause.
24. the data feed and the trainer's side features: (a) `ops.dsp.resample`
   of 10 s at 44.1 and 48 kHz to 16 kHz on the card against float64 numpy
   over the same phase table (1e-5 of the signal's largest value), then
   600 s at 44.1 kHz timed, the first call apart; (b) `tpu_fast`'s
   synthetic corpus at 44.1 kHz (64 speakers, 3 files of 4 s), 16 of its
   files rewritten as FLAC by `data.flac_encoder` (8 stereo, mid-side),
   decoded bit-equal to their PCM by the native decoder (built by g++
   here), the decode rate on the host; (c) `python -m
   cpc_tpu_torch.data.pack` of that corpus at 16 kHz on the card, every
   packed snippet bit-equal to the live decode through `SnippetDataset`;
   (d) `cpc_tpu_torch.train.cli.main --packed --device-corpus --augment`
   for 10 steps of `tpu_fast`: metrics, checkpoint, the GRU and fused heads
   kernels once a step and the other loss kernels never, TensorBoard's
   tags in `tb/` (read here, CRCs checked), then 5 + 5 steps with
   `--resume` bit-equal under the CLI's own cuDNN settings; (e) one step
   through the device corpus against the host batch on the same indices,
   bit-equal (cuDNN deterministic: two different computations),
   then the host-batch step, the device-corpus step and the latter with
   augmentation timed in turns; (f) `augment_waveform` on the card's
   generator, each factor alone over 4 096 rows: gains, the polarity rate,
   shifts recovered from a ramp, the measured SNR; (g) the CLI under
   `--supervise --stale-after 120` for 20 steps, its child SIGKILLed once
   its first checkpoint lands: restarted, exit 0, the final parameters
   bit-equal to an unsupervised run's (both under the CLI's own cuDNN
   settings), the restart's cost; (h) 3 steps
   with `--profile` (a Chrome trace with CUDA kernels), 3 with
   `--nan-debug`, and a Trainer step with a NaN weight under
   `enable_nan_debug`, which must raise FloatingPointError naming step 1;
25. export, the serving artifacts of `export.py`, which hold no kernel:
   (a) `cpc_tpu_torch.eval.cli.main --export-model` on phase 20's workdir
   on the card (symbolic batch; the CLI's wall printed), the program on
   CUDA at 64 x 20 480 and at B = 1 and, moved, on the CPU at B = 4,
   against the live model (z within 2e-2 of max |z|, c within 2e-2: the
   GRU kernel against the plain recurrence in bf16), no kernel launched by
   it; its extraction rate beside the live model's on the same batches and
   `extract_features`' (in turns), and with torch's default cuDNN TF32;
   (b) the streaming steps of phase 20's workdir (through the CLI) and of
   a seed-0 `transformer_fast` (through `export_streaming_step`), fp32,
   through the server's artifact backend in pushes of 1 s over 10 s,
   against StreamingExtractor at phase 21's tolerances, each push timed
   beside the live push; (c) `cpc_tpu_torch.serve.main --artifact` on i16
   stdin: the header equal to `--workdir`'s, the summary with its dropped
   tail, the frames bit-equal to the program driven at fp32 on the same
   windows and within phase 21's tolerances of `--workdir`'s, the serve
   loop's rate beside `--workdir`'s; (b) and (c) with torch's default TF32
   settings in force, as a server process has them;
   (d) every exported graph calls aten, prims and operator functions only.
26. the rings, which hold no kernel of their own (plain tensor code, as
   the JAX package's are plain einsum): (a) `loss.ring` under data
   parallelism: dp_global_negatives with negatives=all_steps (its other
   loss flags kept: the JAX chooser refuses none of them) at batch 64,
   bf16, on R = 2 and 4 ranks played by threads on the card, against the
   same ranks gathering the pool (the all-steps kernels): loss, per-k
   accuracy, grad_norm and the watched gradients at phase 23(b)'s DP_TOL,
   the GRU kernels once a rank, no all-steps kernel on the ring;
   (b) context parallelism at transformer_fast's widths (loss knobs at
   their defaults, negatives=all_steps), ring and zigzag, at 64 x 20 480
   on one NCCL rank and on 2 and 4 thread ranks and at 8 x 163 840 on 4,
   against the single-device all-steps step with attn_impl=flash (the
   attention and all-steps kernels) on the same batch, in the band of
   phase 13's tolerances, each step's ms beside the single-device step's
   (in turns), no kernel launched by a CP step; and at transformer_gar's
   widths in fp32 with TF32 off on 4 thread ranks against its
   single-device step at the JAX package's CP tolerances; (c) DP x CP on
   2 x 2 thread ranks, fp32: audio -> loss with every parameter's
   gradient, the full step, and the step with augmentation, each against
   one device; (d) train.parallel=cp through the training CLI at a world
   of one for 10 steps, then 5 + 5 resumed, bit-equal under the CLI's own
   cuDNN settings;
27. the three fp32 presets no other phase trains (baseline at batch 8,
   maestro_scalogram, transformer_gar): 10 steps through the training CLI
   (finite metrics; the GRU kernels once a step where the gar is a GRU,
   nothing else), an extraction through the eval CLI from that workdir,
   and one step on the card against the same step on the CPU at A11_TOL,
   under torch's default settings as a user's process has them (the step
   turns TF32 off for an fp32 model itself), that step twice bit-equal;
   then its time against the same step with cuDNN's TF32 convs, in 10
   alternating pairs of turns, the cost called unresolved where the pairs
   differ in sign; the fp32 dp_global_negatives step twice bit-equal; the
   spread with cuDNN's default conv backward reported for each (C16);
28. tensor parallelism (`parallel/tp.py`) on ranks played by threads on
   the card: tpu_fast at full width (bf16, 64 x 20 480, K 12,
   ar.use_pallas) on (data, model) = (1, 2), (2, 2), (1, 4) against the
   single-device step on the plain loss (loss, per-k accuracy, grad_norm,
   the gathered gradients of conv0, wi and the heads), the GRU kernels
   once a rank a step; transformer_fast's widths in fp32 with xla and
   flash16 attention (the flash kernels on each rank's heads) on (1, 2)
   and (1, 4) at the JAX package's CP tolerances; each TP step's ms beside
   the single-device step's (in turns) and a step's TP collectives (count,
   bytes, ms).

With `--dp-cards N` it runs data parallelism across N cards under NCCL
instead, what one card cannot run (`dp_cards_main`); with `--cp-cards N`
context parallelism across N cards (`cp_cards_main`); with `--tp-cards N`
tensor parallelism across N cards, one NCCL process a card
(`tp_cards_main`); with `--hosts 2` a run across two "hosts" through the
training CLI (`hosts_main`).

It prints a JSON line of the kernels it checked, each with its launches on
its main path, its error against its plain version, its time, its plain
version's time, the least time the card could take (`bound_ms`: the larger
of the bytes it must move over 3.35 TB/s and its operations over the peak
rate of its input type, from this run's tensors) and, where one PyTorch
call computes the same function, that call's time (`library_ms`), its
launches a rank under data parallelism (`dp_launches`: the CLI's one-rank
run of phase 23(d) for the GRU's and the fused heads' kernels, one step of
phase 23(b) for the other paths' loss kernels) and its time at the DP
shape (`dp_ms`, phase 23(c); null for a kernel off the DP path), its
launches in phase 24(d)'s CLI run on the packed corpus (`feed_launches`),
a rank's launches in phase 26(a)'s ring step (`ring_dp_launches`), the
launches of phase 26(b)'s CP steps (`cp_launches`: none, the path is
plain), of phase 27's three CLI runs (`a11_launches`) and of phase 28's
TP steps (`tp_launches`); and, last, one JSON object naming the device.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from cpc_tpu_torch import CPCModel, export, extract_features, presets, serve
from cpc_tpu_torch.config import apply_overrides, from_dict, to_dict
from cpc_tpu_torch.data.dataset import ProbeDataset, SnippetDataset
from cpc_tpu_torch.data import flac
from cpc_tpu_torch.data.flac import read_flac
from cpc_tpu_torch.data.flac_encoder import write_flac
from cpc_tpu_torch.data.loader import (Batcher, device_prepare,
                                       load_device_corpus, to_device)
from cpc_tpu_torch.data.packed import PackedSnippetDataset
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.data.wavio import decode_mono, read_wav, write_wav
from cpc_tpu_torch.eval import cli as eval_cli
from cpc_tpu_torch.eval import probes
from cpc_tpu_torch.eval.cli import load_weights
from cpc_tpu_torch.eval.streaming import (StreamingExtractor,
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
from cpc_tpu_torch.ops import conv_cuda, dsp
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
from cpc_tpu_torch.ops.ring_util import Ring, run_thread_ranks
from cpc_tpu_torch.parallel import cp, dp, multihost, tp
from cpc_tpu_torch.parallel.mesh import groups_of, thread_meshes
from cpc_tpu_torch.train import cli as train_cli
from cpc_tpu_torch.train import train_step as train_step_module
from cpc_tpu_torch.train.checkpoint import CheckpointManager
from cpc_tpu_torch.train.metrics import masked_crc32c
from cpc_tpu_torch.train.supervisor import latest_checkpoint_step
from cpc_tpu_torch.train.train_step import (global_norm, init_state,
                                            make_step_fns)
from cpc_tpu_torch.train.trainer import Trainer
from cpc_tpu_torch.utils.precision import fp32_exact
from cpc_tpu_torch.utils.profiling import enable_nan_debug

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


def heads_checks(errs: dict, cases=HEADS_CASES) -> None:
    """The fused heads kernels against their plain versions at `cases`;
    raises on the first disagreement and keeps the largest absolute errors
    in `errs`."""
    for n, ((T, B, C, K, D, shift), dtype) in enumerate(cases):
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
                  per_step: dict, workdir=None, data="synthetic") -> dict:
    """Trains `config` through `cpc_tpu_torch.train.cli.main` for `steps`
    steps on `data` with the arguments `extra`, every count set to 0 just
    before, in `workdir` (else a temporary one). Checks the metrics, the
    checkpoint and every kernel's launch count: per_step[name] per step, 0
    for a kernel it does not name. Returns the counts."""
    for fn in COUNTED.values():
        fn.launches = 0
    with (contextlib.nullcontext(workdir) if workdir
          else tempfile.TemporaryDirectory()) as workdir:
        t0 = time.perf_counter()
        rc = train_cli.main(["--config", config, "--data", data,
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
    loss_checks(errs, LOSS_CASES)
    out = {}
    for shape in (LOSS_SLICE, LOSS_LONG):
        times = loss_times_ms(shape, tuple(LOSS_KERNELS))
        if shape == LOSS_SLICE:
            out = times
        print_loss_times(card, shape, times)
    for name, m in out.items():
        m.update(max_abs_err=errs[name], library_ms=None)
    return out


def print_loss_times(card: str, shape, times: dict) -> None:
    for name, m in times.items():
        simt = f" [SIMT kernels of the same call {m['simt_ms']:.4f} " \
            f"ms]" if "simt_ms" in m else ""
        print(f"time {name} at {shape[:5]} shift {shape[5]}, bf16, on "
              f"{card}: kernel {m['ms']:.4f} ms = {m['tflops']:.1f} "
              f"TFLOP/s{simt}, plain {m['plain_ms']:.4f} ms, bound "
              f"{m['bound_ms']:.4f} ms by {m['bound_by']}", flush=True)
    if "product_ms" in times.get("allsteps_nll_forward", {}):
        m = times["allsteps_nll_forward"]
        print(f"time of the all-steps score product alone on cuBLAS "
              f"(torch.matmul of (R, D) and (D, N) bf16, another "
              f"function: a yardstick, not library_ms) at "
              f"{shape[:5]} on {card}: {m['product_ms']:.4f} ms = "
              f"{m['product_tflops']:.1f} TFLOP/s", flush=True)


def loss_checks(errs: dict, cases) -> None:
    """The same-step and all-steps kernels against their plain versions at
    `cases`; raises on the first disagreement and keeps the largest
    absolute errors in `errs`."""
    with torch.inference_mode():
        for n, ((B, T, C, K, D, shift), dtype) in enumerate(cases):
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
    with torch_tf32_defaults():
        for name in ("tpu_fast", "transformer_fast"):
            stream_model(card, name)


@contextlib.contextmanager
def torch_tf32_defaults():
    """torch's default TF32 settings inside the block, whatever main() set
    (cuDNN may take TF32, cuBLAS not), as a server process has them; the
    caller's settings are restored after."""
    kept = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
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


# --------------------------------------------------------------- phase 23
# Data parallelism with cross-replica negatives (dp_global_negatives). The
# card is one: NCCL runs a world of one rank; the cross-rank numerics run as
# two ranks sharing the card through gloo, asked for by name (their times
# are no speeds).
DP_WORLD = 2
# path: (--set overrides of dp_global_negatives, the loss path it takes);
# the fused path in fp32 too, where the ranks' sums differ from one
# process's in order only
DP_PATHS = {"fused": ([], "fused"),
            "fuse_heads=false": (["model.loss.fuse_heads=false"],
                                 "fuse_heads=false"),
            "all_steps": (["model.loss.negatives=all_steps"], "all_steps"),
            "fused fp32": (["model.dtype=float32",
                            "model.loss.pallas_bf16=false"], "fused")}
DP_WATCHED = ("gar.layer0.wh", "prediction_heads.weight")
# the per-rank shapes of the DP step's kernels, global batch 64 = 2 x 32,
# rank 1's shift: heads (T, B, C, K, D, shift), the same-step and
# all-steps kernels (B, T, C, K, D, shift), the GRU (T, B, H)
DP_HEADS = (128, 32, 64, 12, 512, 32)
DP_LOSS = (32, 128, 64, 12, 512, 32)
DP_GRU = (128, 32, 256)
DP_CLI_STEPS = 10
# The two ranks against one process on the concatenated batch, through the
# same kernels: the ranks' averages of loss, accuracy and gradients sum in
# another order than one process's, and in bf16 each rank's dz of the pool
# is rounded to bf16 before the ranks' sum (fp32, then rounded once), where
# one process rounds its sum once: the encoder's gradients, and grad_norm
# with them, move by about a bf16 rounding of dz. Phase 7's tolerances
# (STEP_TOL) but for grad_norm, 1e-4. Measured on an H100 80GB HBM3 at
# 700 W, fused path, bf16: loss 0, acc 1.9e-9, grad_norm 3.6e-5, grads
# 5.7e-6 (wh) and 1.4e-6 (W) absolute, 3.4e-3 and 3.3e-3 of their largest
# entry.
DP_TOL = dict(STEP_TOL, grad_norm=1e-4)


def cudnn_settings() -> str:
    """The cuDNN settings of this process, for a line that reports bits."""
    b = torch.backends.cudnn
    return f"cudnn.deterministic {b.deterministic}, benchmark {b.benchmark}"


def resumed_against_straight(straight: str, resumed: str) -> tuple:
    """The newest checkpoints of two workdirs; the model tensors that differ
    between them and the largest absolute difference among those."""
    ckpts = [CheckpointManager(os.path.join(w, "checkpoints"))
             .restore_latest() for w in (straight, resumed)]
    a, b = ckpts[0]["model"], ckpts[1]["model"]
    differ = [k for k, v in a.items() if not torch.equal(v, b[k])]
    worst = max(((a[k].double() - b[k].double()).abs().max().item()
                 for k in differ), default=0.0)
    return ckpts, differ, worst


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_batch(cfg) -> np.ndarray:
    """The seeded global int16 batch of phases 7 and 10."""
    B, S = cfg.data.batch_size, cfg.data.snippet_samples
    return np.clip(np.random.default_rng(3).standard_normal((B, S)) * 3000,
                   -32768, 32767).astype(np.int16)


def dp_config(path: str):
    return apply_overrides(presets.dp_global_negatives(), DP_PATHS[path][0])


def phase23a_one_rank(card: str) -> dict:
    """A full-width dp_global_negatives step on a one-rank NCCL group
    against the tpu_fast step without a mesh, from the same weights on the
    same batch: bit-equal, with cuDNN's deterministic algorithms (both
    steps run the same convolutions; its default wgrad algorithms need not
    give the same bits twice); then both steps' times and the DP layer's
    collectives alone, under the default settings."""
    mesh = multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                device="cuda")
    try:
        check(mesh.device == torch.device("cuda", 0)
              and dist.get_backend() == "nccl", f"{mesh}")
        cfgs = (presets.tpu_fast(), presets.dp_global_negatives())
        models = [init_state(c, "cuda") for c in cfgs]
        steps = [make_step_fns(cfgs[0], models[0]),
                 make_step_fns(cfgs[1], models[1], mesh)]
        batch = torch.from_numpy(dp_batch(cfgs[1])).cuda()
        with forced("deterministic", True, module=torch.backends.cudnn):
            m0, m1 = (s.train_step(batch) for s in steps)
            torch.cuda.synchronize()
        diffs = [k for k in m0 if not torch.equal(m0[k], m1[k])]
        named = list(zip(models[0].named_parameters(),
                         models[1].parameters()))
        diffs += [f"grad {k}" for (k, a), b in named
                  if not torch.equal(a.grad, b.grad)]
        diffs += [f"param {k}" for (k, a), b in named if not torch.equal(a, b)]
        print(f"dp (a): one-rank NCCL dp_global_negatives step vs the "
              f"tpu_fast step (bf16, batch 64, cuDNN deterministic): loss "
              f"{m1['loss'].item():.6f} vs {m0['loss'].item():.6f}, "
              f"grad_norm {m1['grad_norm'].item():.6f} vs "
              f"{m0['grad_norm'].item():.6f}; metrics, the "
              f"{len(named)} gradients and the parameters after the update "
              f"bit-equal: {not diffs} {diffs[:5]}", flush=True)
        check(not diffs, f"one-rank DP step differs from the step: {diffs}")

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        for s in steps:  # warm-up
            for _ in range(3):
                s.train_step(batch)
        runs = {0: [], 1: []}
        for order in ((0, 1), (1, 0)) * 5:  # plain, dp, dp, plain, ...
            for i in order:
                runs[i].append(timed(lambda: steps[i].train_step(batch)))
        step_ms = {i: statistics.median(v) * 1e3 for i, v in runs.items()}
        z = torch.randn((32, 128, 512), device="cuda").to(torch.bfloat16)
        z.requires_grad_()
        pool, _ = dp.gather_pool(z, mesh)
        g = torch.randn_like(pool)
        grads = [p.grad for p in models[1].parameters()]
        n_grad = sum(t.numel() for t in grads)
        times = {
            "gather forward": cuda_ms(lambda: dp.gather_pool(z, mesh)),
            "gather backward": cuda_ms(lambda: torch.autograd.grad(
                pool, z, g, retain_graph=True)),
            "average of the gradients": cuda_ms(
                lambda: dp.average(grads, mesh))}
        print(f"dp (a) times on {card}: the tpu_fast step "
              f"{step_ms[0]:.3f} ms, the one-rank dp_global_negatives step "
              f"{step_ms[1]:.3f} ms (median of 10 each, in turns, CUDA "
              f"sync): the DP layer at a world of one "
              f"{step_ms[1] - step_ms[0]:+.3f} ms a step; alone, eager "
              f"calls between CUDA events (median of 20; the host's enqueue "
              f"of the process group's call bounds them): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
              + f" (pool {tuple(pool.shape)} bf16 of z (32, 128, 512); "
              f"{n_grad} fp32 gradient entries in one buffer)", flush=True)
        return {"step_ms": step_ms[0], "dp_step_ms": step_ms[1], **times}
    finally:
        multihost.shutdown()


def dp_rank_main(argv) -> None:
    """One of phase 23(b)'s ranks: `chip_smoke.py --dp-rank R --dp-port P
    --dp-out DIR`. Joins a gloo group of DP_WORLD ranks on cuda:0, runs one
    dp_global_negatives step of each DP path on its rows of the seeded
    global batch, and saves its metrics, the averaged watched gradients,
    its parameters and the kernels' launches to DIR."""
    args = dict(zip(argv[::2], argv[1::2]))
    rank, out = int(args["--dp-rank"]), args["--dp-out"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = multihost.initialize(f"127.0.0.1:{args['--dp-port']}", DP_WORLD,
                                rank, device="cuda:0", backend="gloo",
                                timeout=300)
    try:
        for path in DP_PATHS:
            cfg = dp_config(path)
            model = init_state(cfg, mesh.device)
            steps = make_step_fns(cfg, model, mesh)
            host = multihost.shard_batch(dp_batch(cfg), mesh)
            local = torch.from_numpy(host).to(mesh.device)
            for fn in COUNTED.values():
                fn.launches = 0
            metrics = steps.train_step(local)
            torch.cuda.synchronize()
            counts = {k: fn.launches for k, fn in COUNTED.items()}
            params = dict(model.named_parameters())
            grads = dp.average([params[k].grad for k in DP_WATCHED], mesh)
            torch.save({"metrics": {k: v.cpu() for k, v in metrics.items()},
                        "grads": {k: g.cpu() for k, g in
                                  zip(DP_WATCHED, grads)},
                        "params": {k: p.detach().cpu()
                                   for k, p in params.items()},
                        "counts": counts, "rows": tuple(host.shape),
                        "shift": mesh.rank * host.shape[0]},
                       os.path.join(out, f"{path}.rank{rank}.pt"))
    finally:
        multihost.shutdown()


def run_ranks(cmds, timeout: float, env=None) -> list:
    """Runs the commands together (with `env` added to the environment);
    kills them all if one fails or the time runs out, and fails then.
    Returns each one's output."""
    logs = [tempfile.TemporaryFile("w+") for _ in cmds]
    env = dict(os.environ, **(env or {}))
    procs = [subprocess.Popen(c, stdout=log, stderr=subprocess.STDOUT,
                              text=True, env=env)
             for c, log in zip(cmds, logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for i, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        texts.append(log.read())
        log.close()
        check(p.returncode == 0, f"dp rank {i} exited {p.returncode}:\n"
              f"{texts[-1][-6000:]}")
    return texts


def phase23b_two_ranks(card: str) -> dict:
    """Two gloo ranks sharing the card against one process's step on the
    concatenated batch, on each DP path (DP_TOL); returns the path kernels'
    launches a rank."""
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        port = free_port()
        run_ranks([[sys.executable, os.path.abspath(__file__), "--dp-rank",
                    str(r), "--dp-port", str(port), "--dp-out", out]
                   for r in range(DP_WORLD)], timeout=600)
        wall = time.perf_counter() - t0
        ranks = {path: [torch.load(os.path.join(out, f"{path}.rank{r}.pt"))
                        for r in range(DP_WORLD)] for path in DP_PATHS}
    print(f"dp (b): {DP_WORLD} gloo ranks on cuda:0, one step of each of "
          f"{list(DP_PATHS)}, in {wall:.1f} s (start-up included; no "
          f"speed: the ranks share one card)", flush=True)
    dtype_of = {True: "bf16", False: "fp32"}
    launches = {}
    for path, (r0, r1) in ranks.items():
        cfg = dp_config(path)
        model = init_state(cfg, "cuda")
        steps = make_step_fns(cfg, model)
        m = steps.train_step(torch.from_numpy(dp_batch(cfg)).cuda())
        params = dict(model.named_parameters())
        mm = r0["metrics"]
        errs = {"loss": abs(mm["loss"].item() - m["loss"].item())
                / abs(m["loss"].item()),
                "acc": (mm["acc"] - m["acc"].cpu()).abs().max().item(),
                "grad_norm": abs(mm["grad_norm"].item()
                                 - m["grad_norm"].item())
                / m["grad_norm"].item()}
        for k in DP_WATCHED:
            want = params[k].grad.cpu()
            errs[f"grad {k}"] = rel_err(r0["grads"][k], want)
            errs[f"grad_of_max {k}"] = rel_to_max(r0["grads"][k], want)
        same = [k for k in r0["params"]
                if not torch.equal(r0["params"][k], r1["params"][k])]
        drift = max((r0["params"][k] - p.detach().cpu()).abs().max().item()
                    for k, p in params.items())
        _, kernels = LOSS_PATHS[DP_PATHS[path][1]]
        want_counts = {k: int(k in GRU_KERNELS + kernels) for k in COUNTED}
        print(f"dp (b) {path} "
              f"({dtype_of[cfg.model.dtype == 'bfloat16']}): ranks' rows "
              f"{r0['rows']} and {r1['rows']}, "
              f"shifts {r0['shift']} and {r1['shift']} in a pool of "
              f"{DP_WORLD * r0['rows'][0]}; two ranks vs one process on the "
              f"concatenated batch: loss {mm['loss'].item():.6f} vs "
              f"{m['loss'].item():.6f}, grad_norm "
              f"{mm['grad_norm'].item():.6f} vs {m['grad_norm'].item():.6f}; "
              f"errors {errs} (tolerances {DP_TOL}); the ranks' parameters "
              f"after the update bit-equal: {not same}; their largest "
              f"distance from one process's {drift:.3e}; launches a rank "
              f"{[r['counts'] for r in (r0, r1)]}", flush=True)
        for k, e in errs.items():
            check(math.isfinite(e) and e <= DP_TOL[k.split()[0]],
                  f"dp (b) {path}: {k} error {e}")
        check(not same, f"dp (b) {path}: ranks' parameters differ: {same}")
        for r in (r0, r1):
            check(r["counts"] == want_counts,
                  f"dp (b) {path}: launches {r['counts']}")
        launches.update({k: r0["counts"][k] for k in kernels})
    return launches


def phase23c_kernels(card: str, measured: dict) -> dict:
    """The kernels at the DP step's per-rank shapes against their plain
    versions (phases 5 and 8's routes and tolerances), then their times
    beside tpu_fast's; returns {name: ms at the DP shape}."""
    errs = dict.fromkeys(COUNTED, 0.0)
    heads_checks(errs, [(DP_HEADS, torch.bfloat16)])
    loss_checks(errs, [(DP_LOSS, torch.bfloat16)])
    T, B, H = DP_GRU
    check(gru_route(B, H, torch.bfloat16) == "resident",
          f"gru {DP_GRU} takes {gru_route(B, H, torch.bfloat16)}")
    with torch.inference_mode():
        xp, wh, bh, h0 = gru_inputs(T, B, H, torch.bfloat16, seed=60)
        g = torch.from_numpy(np.random.default_rng(61).standard_normal(
            (T, B, H))).to("cuda", torch.bfloat16)
        hs = gru_scan_reference(xp, wh, bh, h0)
        got, again = (gru_scan_backward(xp, wh, bh, h0, hs, g)
                      for _ in range(2))
        want = gru_scan_backward_reference(xp, wh, bh, h0, hs, g)
        torch.cuda.synchronize()
        for name, a, a2, b in zip(("dxproj", "dwh", "dbh", "dh0"), got,
                                  again, want):
            tol = REL_TOL[torch.float32 if b.dtype == torch.float32
                          else torch.bfloat16]
            err = rel_err(a, b)
            print(f"gru_scan_backward vs plain {DP_GRU} bf16 (resident "
                  f"route) {name}: relative to max(1, max |plain|) "
                  f"{err:.3e} (tol {tol:.0e}); two runs bit-identical "
                  f"{torch.equal(a, a2)}", flush=True)
            check(torch.equal(a, a2) and err <= tol,
                  f"gru bwd {DP_GRU} {name}: {err}")
        args = (xp, wh, bh, h0)
        dp_ms = {"gru_scan": cuda_ms(lambda: gru_scan(*args)),
                 "gru_scan_backward": cuda_ms(
                     lambda: gru_scan_backward(*args, hs, g))}
        # phases 3 and 5's bounds, from this run's tensors
        bounds = {"gru_scan": bound([*args, hs], 2 * T * B * H * 3 * H),
                  "gru_scan_backward": bound([*args, hs, g, *got],
                                             3 * 2 * T * B * H * 3 * H)}
    for name, ms in dp_ms.items():
        print(f"time {name} at the DP shape {DP_GRU} bf16 on {card}: "
              f"{ms:.4f} ms, bound {bounds[name]['bound_ms']:.6f} ms by "
              f"{bounds[name]['bound_by']} (tpu_fast's {SLICE_SHAPE}: "
              f"{measured[name]['ms']:.4f} ms)", flush=True)
    for name, m in heads_times_ms(DP_HEADS).items():
        dp_ms[name] = m["ms"]
        print(f"time {name} at the DP shape {DP_HEADS[:5]} shift "
              f"{DP_HEADS[5]} bf16 on {card}: {m['ms']:.4f} ms [SIMT "
              f"{m['simt_ms']:.4f} ms], plain {m['plain_ms']:.4f} ms, "
              f"bound {m['bound_ms']:.4f} ms by {m['bound_by']} "
              f"(tpu_fast's {HEADS_SLICE[:5]}: {measured[name]['ms']:.4f} "
              f"ms)", flush=True)
    times = loss_times_ms(DP_LOSS, tuple(LOSS_KERNELS))
    print_loss_times(card, DP_LOSS, times)
    for name, m in times.items():
        dp_ms[name] = m["ms"]
        print(f"time {name} at the DP shape: {m['ms']:.4f} ms against "
              f"{measured[name]['ms']:.4f} ms at tpu_fast's", flush=True)
    return dp_ms


def phase23d_cli(card: str) -> dict:
    """dp_global_negatives through the training CLI on a one-rank NCCL
    group: 10 steps (the kernels' launches counted), then 5 + 5 with a
    resume, equal bit for bit under the program's own cuDNN settings;
    then --num-processes 2 on the one card must fail with NCCL's cause.
    Returns the straight run's launches."""
    with tempfile.TemporaryDirectory() as root:
        straight, resumed = (os.path.join(root, n) for n in ("a", "b"))

        def dp_args():
            return ["--coordinator", f"127.0.0.1:{free_port()}",
                    "--num-processes", "1", "--process-id", "0",
                    "--set", "train.log_every=1"]
        counts = train_cli_run("dp_global_negatives", "dp_global_negatives",
                               dp_args(), DP_CLI_STEPS,
                               {k: 1 for k in GRU_KERNELS + HEADS_KERNELS},
                               workdir=straight)
        corpus = os.path.join(straight, "synthetic_corpus")
        for steps, extra in ((5, []), (DP_CLI_STEPS, ["--resume"])):
            rc = train_cli.main(["--config", "dp_global_negatives", "--data",
                                 corpus, "--workdir", resumed, "--steps",
                                 str(steps), *dp_args(), *extra])
            check(rc == 0, f"dp cli leg of {steps} steps returned {rc}")

        def losses(wd):
            with open(os.path.join(wd, "metrics.jsonl")) as f:
                return {r["step"]: r["loss"] for r in map(json.loads, f)
                        if r["prefix"] == "train"}
        a, b = losses(straight), losses(resumed)
        ckpts, differ, worst = resumed_against_straight(straight, resumed)
        print(f"dp (d): {DP_CLI_STEPS} CLI steps straight vs 5 + "
              f"{DP_CLI_STEPS - 5} resumed (one-rank NCCL, "
              f"{cudnn_settings()}): losses {[a[k] for k in sorted(a)]} vs "
              f"{[b[k] for k in sorted(b)]}; step {DP_CLI_STEPS} "
              f"checkpoints' tensors that differ: {differ}, largest "
              f"absolute difference {worst:.3e}", flush=True)
        check(a == b and sorted(a) == list(range(1, DP_CLI_STEPS + 1)),
              "the resumed DP run's losses differ from the straight run's")
        check(not differ and ckpts[0]["meta"] == ckpts[1]["meta"],
              f"the resumed DP run's checkpoint differs: {differ}")
        proc = subprocess.run(
            [sys.executable, "-m", "cpc_tpu_torch.train", "--config",
             "dp_global_negatives", "--device", "cuda", "--steps", "1",
             "--workdir", os.path.join(root, "c"), "--coordinator",
             f"127.0.0.1:{free_port()}", "--num-processes", "2",
             "--process-id", "0"],
            capture_output=True, text=True, timeout=300)
        said = proc.stderr.strip().splitlines()[-1:] or [""]
        print(f"dp (d): --num-processes 2 on one card under --device cuda "
              f"exits {proc.returncode}: {said[0]}", flush=True)
        check(proc.returncode != 0
              and "two ranks on one device" in proc.stderr,
              f"two NCCL ranks on one card: rc {proc.returncode}, "
              f"{proc.stderr[-2000:]}")
    return counts



# ---------------------------------------------------------------- phase 24
FEED_SR = 44_100
FEED_FLAC = 16          # files of the corpus written as FLAC, half stereo
FEED_CLI_STEPS = 10
SUPERVISED_STEPS = 20
TB_TAGS = {"train/loss", "train/acc_mean", "train/audio_sec_per_sec",
           *(f"train/acc_{k}" for k in range(1, 13))}


def resample_f64(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """`resample`'s sum in float64 numpy, over the same float32 phase table
    (cast up once): out[m] = sum_q xp[m*down//up + q] * h[m*down % up, q]."""
    h, up, down = dsp._resample_kernel(sr_in, sr_out)
    h = h.astype(np.float64)
    taps = h.shape[1]
    xp = np.pad(x.astype(np.float64), (taps // 2, taps // 2))
    m = np.arange(len(x) * up // down)
    out = np.empty(len(m))
    for a in range(0, len(m), 20_000):
        mm = m[a:a + 20_000]
        win = xp[(mm * down // up)[:, None] + np.arange(taps)[None, :]]
        out[a:a + 20_000] = (win * h[mm * down % up]).sum(1)
    return out


def phase24a_resample(card: str) -> None:
    """10 s at 44.1 and 48 kHz to 16 kHz on the card against float64
    numpy; then 600 s at 44.1 kHz timed."""
    rng = np.random.default_rng(24)
    for sr in (44_100, 48_000):
        t = np.arange(10 * sr) / sr
        x = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(
            2 * np.pi * 5_000 * t) + 0.05 * rng.standard_normal(len(t))
             ).astype(np.float32)
        got = dsp.resample(torch.from_numpy(x[None]).cuda(), sr, 16_000)
        want = resample_f64(x, sr, 16_000)
        err = float(np.abs(got[0].double().cpu().numpy() - want).max()
                    / np.abs(want).max())
        print(f"feed (a): resample {sr} -> 16000 Hz of 10 s on the card: "
              f"{tuple(got.shape)}, max error {err:.3e} of the signal's "
              f"largest value against float64 numpy (tol 1e-5)", flush=True)
        check(got.shape == (1, len(want)) and err <= 1e-5,
              f"resample {sr}: error {err}")
    x = torch.from_numpy(rng.standard_normal((1, 600 * FEED_SR)).astype(
        np.float32) * 0.1).cuda()

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dsp.resample(x, FEED_SR, 16_000)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    first = timed()
    runs = [timed() for _ in range(5)]
    print(f"feed (a): resample of 600 s at 44.1 kHz on {card}: first call "
          f"{first:.4f} s, then {statistics.median(runs):.4f} s (median of "
          f"5, host clock, CUDA sync) = {600 / statistics.median(runs):.0f} "
          f"audio-s/s", flush=True)


def phase24b_flac(card: str, root: str) -> str:
    """tpu_fast's corpus at 44.1 kHz (64 speakers, 3 files of 4 s), 16 of
    its files rewritten as FLAC (half stereo): each decodes to its PCM."""
    corpus = os.path.join(root, "corpus44")
    t0 = time.perf_counter()
    paths = generate_synthetic_corpus(corpus, num_speakers=64,
                                      files_per_speaker=3,
                                      seconds_per_file=4.0,
                                      sample_rate=FEED_SR, seed=0)
    made = time.perf_counter() - t0
    written, t0 = [], time.perf_counter()
    for i, path in enumerate(paths[::len(paths) // FEED_FLAC][:FEED_FLAC]):
        x, sr = read_wav(path)
        pcm = np.round(x[:, 0].astype(np.float64) * 32768).astype(np.int64)
        if i % 2:  # stereo: a second channel, mid-side coded
            pcm = np.stack([pcm, (3 * pcm) // 4], axis=1)
        flac_path = path[:-4] + ".flac"
        write_flac(flac_path, pcm, sr,
                   stereo_mode="mid_side" if i % 2 else "independent")
        os.remove(path)
        written.append((flac_path, pcm))
    enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    flac.load_library()  # g++ builds the decoder here, at first use
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = [read_flac(p) for p, _ in written]
    dec = time.perf_counter() - t0
    for (path, pcm), (y, sr) in zip(written, decoded):
        got = np.round(y.astype(np.float64) * 32768).astype(np.int64)
        check(sr == FEED_SR and np.array_equal(
            got, pcm if pcm.ndim == 2 else pcm[:, None]),
              f"{path}: decoded samples differ from the encoded PCM")
    audio = sum(len(p) for _, p in written) / FEED_SR
    print(f"feed (b): corpus of {len(paths)} files of 4 s at 44.1 kHz "
          f"written in {made:.2f} s; {FEED_FLAC} as FLAC ({FEED_FLAC // 2} "
          f"stereo) encoded in {enc:.2f} s (numpy, bit by bit); the "
          f"decoder built by g++ and loaded in {built:.2f} s; decoded "
          f"bit-equal to their PCM, {audio:.1f} audio-s in {dec:.4f} s = "
          f"{audio / dec:.0f} audio-s/s on the host of {card}", flush=True)
    return corpus


def phase24c_pack(card: str, root: str, corpus: str) -> str:
    """`python -m cpc_tpu_torch.data.pack` at 16 kHz on the card; every
    packed snippet bit-equal to the live decode."""
    packed = os.path.join(root, "packed")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cpc_tpu_torch.data.pack",
                           corpus, packed, "--rate", "16000"],
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"pack exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    S = presets.tpu_fast().data.snippet_samples
    ds, live = PackedSnippetDataset(packed, S), SnippetDataset(corpus, S,
                                                               device="cuda")
    differ = [i for i in range(len(ds))
              if not np.array_equal(ds.snippet_int16(i),
                                    live.snippet_int16(i))]
    print(f"feed (c): python -m cpc_tpu_torch.data.pack on the card "
          f"({card}): {proc.stdout.strip()} in {wall:.2f} s wall (process "
          f"start-up included); {len(ds)} snippets, {len(differ)} differ "
          f"from the live decode through SnippetDataset", flush=True)
    check(len(ds) == len(live) == 576 and not differ,
          f"packed snippets differ from the live decode: {differ[:5]}")
    return packed


def tb_scalars(log_dir: str) -> dict:
    """{tag: [(step, value)]} from the event files under log_dir, every
    record's masked CRC-32C checked; a small reader of TFRecord framing and
    of the Event, Summary and Value protobufs."""
    def fields(buf):
        pos = 0
        while pos < len(buf):
            key, pos = varint(buf, pos)
            num, wire = key >> 3, key & 7
            if wire == 0:
                val, pos = varint(buf, pos)
            elif wire == 1:
                val, pos = buf[pos:pos + 8], pos + 8
            elif wire == 2:
                n, pos = varint(buf, pos)
                val, pos = buf[pos:pos + n], pos + n
            elif wire == 5:
                val, pos = buf[pos:pos + 4], pos + 4
            else:
                raise ValueError(f"wire type {wire}")
            yield num, val

    def varint(buf, pos):
        out = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return out, pos

    scalars: dict = {}
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            head = data[pos:pos + 8]
            (n,) = struct.unpack("<Q", head)
            payload = data[pos + 12:pos + 12 + n]
            crcs = struct.unpack("<II", data[pos + 8:pos + 12]
                                 + data[pos + 12 + n:pos + 16 + n])
            check(crcs == (masked_crc32c(head), masked_crc32c(payload)),
                  f"{name}: a record's CRC does not match")
            pos += 16 + n
            event = dict(fields(payload))
            for num, value in fields(event.get(5, b"")):
                v = dict(fields(value))
                scalars.setdefault(v[1].decode(), []).append(
                    (event.get(2, 0), struct.unpack("<f", v[2])[0]))
    return scalars


def phase24d_train(card: str, root: str, packed: str) -> dict:
    """tpu_fast through the CLI on the packed corpus with --packed
    --device-corpus --augment: launches, metrics, checkpoint and
    TensorBoard tags; then 5 + 5 steps with --resume bit-equal to the
    straight run under the program's own cuDNN settings."""
    feed = ["--packed", "--device-corpus", "--augment"]
    straight, resumed = (os.path.join(root, n) for n in ("d_a", "d_b"))
    counts = train_cli_run("packed, device corpus, augment", "tpu_fast",
                           feed, FEED_CLI_STEPS,
                           {k: 1 for k in GRU_KERNELS + HEADS_KERNELS},
                           workdir=straight, data=packed)
    for steps, extra in ((5, []), (FEED_CLI_STEPS, ["--resume"])):
        rc = train_cli.main(["--config", "tpu_fast", "--data", packed,
                             *feed, "--workdir", resumed, "--steps",
                             str(steps), *extra])
        check(rc == 0, f"feed cli leg of {steps} steps returned {rc}")
    scalars = tb_scalars(os.path.join(straight, "tb"))
    with open(os.path.join(straight, "metrics.jsonl")) as f:
        last = [json.loads(line) for line in f][-1]
    missing = TB_TAGS - set(scalars)
    print(f"feed (d): tb/ holds {len(scalars)} tags, "
          f"{sorted(scalars)[:6]}...; train/loss at step "
          f"{scalars['train/loss'][-1][0]}: {scalars['train/loss'][-1][1]} "
          f"(metrics.jsonl {last['loss']}); missing {sorted(missing)}",
          flush=True)
    check(not missing and scalars["train/loss"][-1] == (
        FEED_CLI_STEPS, np.float32(last["loss"])),
          f"TensorBoard tags: missing {missing}")
    ckpts, differ, worst = resumed_against_straight(straight, resumed)
    print(f"feed (d): {FEED_CLI_STEPS} CLI steps straight vs 5 + "
          f"{FEED_CLI_STEPS - 5} resumed under --augment "
          f"({cudnn_settings()}): step {ckpts[1]['meta']['step']} "
          f"checkpoints' tensors that differ: {differ}, largest absolute "
          f"difference {worst:.3e}", flush=True)
    check(not differ and ckpts[0]["meta"] == ckpts[1]["meta"],
          f"the resumed --augment run differs: {differ}")
    return counts


def phase24e_feeds(card: str, packed: str) -> dict:
    """One tpu_fast step through the device corpus against the host batch
    on the same indices (bit-equal, cuDNN deterministic); then the two
    feeds' steps and the step with --augment timed in turns."""
    base = presets.tpu_fast()
    cfgs = {name: dataclasses.replace(base, data=dataclasses.replace(
        base.data, device_corpus=dc, augment=aug))
        for name, dc, aug in (("host", False, False), ("device", True, False),
                              ("augment", True, True))}
    ds = PackedSnippetDataset(packed, base.data.snippet_samples)
    corpus = load_device_corpus(ds, "cuda")
    models = {k: init_state(c, "cuda") for k, c in cfgs.items()}
    steps = {k: make_step_fns(cfgs[k], m).train_step
             for k, m in models.items()}
    batcher = Batcher(ds, base.data.batch_size, seed=0, yield_indices=True)
    idx = next(iter(batcher))[2]
    batcher.close()

    def host_step():
        host = np.stack([ds.snippet_int16(int(i)) for i in idx])
        return steps["host"](to_device(host, "cuda"))

    def device_step(name="device"):
        return steps[name](corpus, to_device(idx, "cuda"))
    with forced("deterministic", True, module=torch.backends.cudnn):
        m0, m1 = host_step(), device_step()
        torch.cuda.synchronize()
    diffs = [k for k in m0 if not torch.equal(m0[k], m1[k])]
    named = list(zip(models["host"].named_parameters(),
                     models["device"].parameters()))
    diffs += [f"grad {k}" for (k, a), b in named
              if not torch.equal(a.grad, b.grad)]
    diffs += [f"param {k}" for (k, a), b in named if not torch.equal(a, b)]
    print(f"feed (e): the device-corpus step vs the host-batch step on the "
          f"same indices (tpu_fast, bf16, cuDNN deterministic): loss "
          f"{m1['loss'].item():.6f} vs {m0['loss'].item():.6f}; metrics, "
          f"the {len(named)} gradients and the parameters after the update "
          f"bit-equal: {not diffs} {diffs[:5]}", flush=True)
    check(not diffs, f"device-corpus step differs from the host step: "
          f"{diffs}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    fns = {"host": host_step, "device": device_step,
           "augment": lambda: device_step("augment"),
           "assembly": lambda: np.stack([ds.snippet_int16(int(i))
                                         for i in idx])}
    for fn in fns.values():
        for _ in range(3):
            fn()
    runs = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]) * 5:
        for k in order:
            runs[k].append(timed(fns[k]))
    ms = {k: statistics.median(v) * 1e3 for k, v in runs.items()}
    print(f"feed (e) times on {card}, tpu_fast bf16 batch 64 (median of 10 "
          f"each, in turns, host clock, CUDA sync): the host-batch step "
          f"{ms['host']:.3f} ms (the packed batch's assembly on the host "
          f"{ms['assembly']:.3f} ms of it, then the pinned copy), the "
          f"device-corpus step {ms['device']:.3f} ms "
          f"({ms['host'] - ms['device']:+.3f} ms for the host feed), the "
          f"device-corpus step with --augment {ms['augment']:.3f} ms "
          f"({ms['augment'] - ms['device']:+.3f} ms for the augmentation)",
          flush=True)
    return ms


def phase24f_augment(card: str) -> None:
    """augment_waveform on the card, each factor alone, by distribution
    over 4 096 rows of the card's generator."""
    rows, S, snr_db = 4096, 20_480, 30.0
    d = presets.tpu_fast().data

    def aug(x, **kw):
        opts = {**dict(gain_db=0.0, noise_snr_db=100.0, shift_max=0,
                       polarity=False), **kw}
        gen = torch.Generator(device="cuda").manual_seed(24)
        return dsp.augment_waveform(x, gen, **opts).double().cpu().numpy()
    ones = torch.ones((rows, 64), device="cuda")
    db = 20 * np.log10(aug(ones, gain_db=d.augment_gain_db)[:, 0])
    flips = (aug(ones, polarity=True)[:, 0] < 0).mean()
    ramp = torch.arange(S, device="cuda", dtype=torch.float32).expand(rows, S)
    out = aug(ramp, shift_max=d.augment_shift_max)
    shift = out[:, 0].astype(np.int64)
    shift = np.where(shift > S // 2, shift - S, shift)
    exact = np.array_equal(out, (np.arange(S)[None, :] + shift[:, None]) % S)
    x = torch.randn((rows, S), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    noisy = aug(x, noise_snr_db=snr_db)
    clean = x.double().cpu().numpy()
    snr = 10 * np.log10((clean ** 2).mean(1)
                        / ((noisy - clean) ** 2).mean(1))
    print(f"feed (f): augmentation on {card}, 4 096 rows each: gain "
          f"{db.min():+.4f} to {db.max():+.4f} dB (+-{d.augment_gain_db}); "
          f"polarity flipped {flips:.4f} (0.5 +- 0.03); shifts "
          f"{shift.min()} to {shift.max()} (+-{d.augment_shift_max}), "
          f"recovered exactly from a ramp: {exact}; measured SNR "
          f"{snr.min():.3f} to {snr.max():.3f} dB ([{snr_db:.0f}, "
          f"{snr_db + 20:.0f}] over {S} samples)", flush=True)
    check(np.abs(db).max() <= d.augment_gain_db + 1e-4
          and db.min() < -5.9 and db.max() > 5.9, f"gains {db.min()}, "
          f"{db.max()}")
    check(abs(flips - 0.5) <= 0.03, f"polarity rate {flips}")
    check(exact and np.abs(shift).max() == d.augment_shift_max,
          "shifts not recovered")
    # a noise power over 20 480 samples: within 0.15 dB at 4 sigma
    check(snr.min() > snr_db - 0.15 and snr.max() < snr_db + 20.15,
          f"SNR {snr.min()} to {snr.max()}")


def phase24g_supervisor(card: str, root: str, packed: str) -> None:
    """The CLI under --supervise, its child SIGKILLed once its first
    checkpoint lands: restarted, exit 0, final parameters bit-equal to an
    unsupervised run's, both under the program's own cuDNN settings."""
    supervised, plain = (os.path.join(root, n) for n in ("g_sup", "g_plain"))
    args = [sys.executable, "-m", "cpc_tpu_torch.train", "--config",
            "tpu_fast", "--data", packed, "--packed", "--device-corpus",
            "--augment", "--steps", str(SUPERVISED_STEPS), "--set",
            "train.checkpoint_every=5", "--set", "train.log_every=1"]
    proc = subprocess.Popen([*args, "--workdir", supervised, "--supervise",
                             "--stale-after", "120"],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    pid_path = os.path.join(supervised, "supervisor_child.pid")
    killed_at, deadline = None, time.time() + 600
    try:
        while proc.poll() is None and time.time() < deadline:
            if killed_at is None and os.path.exists(pid_path) and \
                    latest_checkpoint_step(supervised) >= 5:
                with open(pid_path) as f:
                    os.kill(int(f.read()), signal.SIGKILL)
                killed_at = time.time()
            time.sleep(0.005)
        _, err = proc.communicate(timeout=max(1, deadline - time.time()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0 and killed_at is not None,
          f"supervised run exited {proc.returncode}, killed "
          f"{killed_at is not None}: {err[-2000:]}")
    with open(os.path.join(supervised, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    after = [r for r in recs if r["time"] > killed_at]
    restart_s = after[0]["time"] - killed_at
    rc = subprocess.run([*args, "--workdir", plain],
                        capture_output=True, text=True, timeout=600)
    check(rc.returncode == 0, f"unsupervised run: {rc.stderr[-2000:]}")
    ckpts, differ, worst = resumed_against_straight(plain, supervised)
    print(f"feed (g): --supervise --stale-after 120, {SUPERVISED_STEPS} "
          f"steps, child SIGKILLed after its step-5 checkpoint: exit "
          f"{proc.returncode}, resumed at step {after[0]['step']}; restart "
          f"cost {restart_s:.2f} s from the kill to the resumed child's "
          f"first step logged (the supervisor's 10 s backoff, the new "
          f"process, the corpus upload and the step included) on {card}; "
          f"final tensors that differ from an unsupervised run's (both "
          f"under the CLI's own cuDNN settings): {differ}, largest absolute "
          f"difference {worst:.3e}", flush=True)
    check(not differ and ckpts[0]["meta"] == ckpts[1]["meta"]
          and ckpts[1]["meta"]["step"] == SUPERVISED_STEPS,
          f"the supervised run's parameters differ: {differ}")


def phase24h_debug(card: str, root: str, packed: str) -> None:
    """3 steps with --profile leave a trace; 3 with --nan-debug finish; a
    Trainer step with a NaN weight under nan-debug raises
    FloatingPointError naming the step."""
    feed = ["--packed", "--device-corpus", "--augment"]
    per_step = {k: 1 for k in GRU_KERNELS + HEADS_KERNELS}
    wd = os.path.join(root, "h_profile")
    train_cli_run("--profile", "tpu_fast", [*feed, "--profile"], 3,
                  per_step, workdir=wd, data=packed)
    trace_path = os.path.join(wd, "profile", "trace.json")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"feed (h): --profile wrote {trace_path} "
          f"({os.path.getsize(trace_path)} bytes, {len(events)} events, "
          f"{kernels} of them CUDA kernels)", flush=True)
    check(kernels > 0, "the trace holds no CUDA kernel")
    train_cli_run("--nan-debug", "tpu_fast", [*feed, "--nan-debug"], 3,
                  per_step, workdir=os.path.join(root, "h_nan"), data=packed)
    cfg = presets.tpu_fast()
    trainer = Trainer(cfg, PackedSnippetDataset(packed,
                                                cfg.data.snippet_samples),
                      device="cuda")
    try:
        with torch.no_grad():
            trainer.model.prediction_heads.weight[0, 0] = float("nan")
        enable_nan_debug()
        try:
            trainer.train(1)
            raised = "no error"
        except FloatingPointError as e:
            raised = str(e)
    finally:
        enable_nan_debug(False)
        trainer.close()
    print(f"feed (h): a Trainer step with one NaN weight under nan-debug "
          f"raised FloatingPointError: {raised!r}", flush=True)
    check("at step 1, in the forward" in raised, f"nan-debug: {raised}")


def phase24_feed(card: str) -> dict:
    """Phase 24: resampling, FLAC, packing, the feeds through the CLI and
    against each other, augmentation, the supervisor, profiling and
    nan-debug. Returns the CLI run's launches."""
    with tempfile.TemporaryDirectory() as root:
        phase24a_resample(card)
        corpus = phase24b_flac(card, root)
        packed = phase24c_pack(card, root, corpus)
        counts = phase24d_train(card, root, packed)
        phase24e_feeds(card, packed)
        phase24f_augment(card)
        phase24g_supervisor(card, root, packed)
        phase24h_debug(card, root, packed)
    return counts


# ---------------------------------------------------------------- phase 25
# The serving artifacts (export.py) run the plain path; the live model runs
# the GRU kernel. On c the two differ as kernel and plain differ in bf16
# (TOL); on z they differ by where a bf16 conv rounds (the artifact's fp32
# product rounded once against cuDNN's bf16 conv): held relative to the
# largest |z|, at one bf16 rounding's size.
EXPORT_Z_TOL = 2e-2
# latents a call of a streaming-step artifact: its graph unrolls them (the
# GRU's recurrence, the transformer's decode steps), so the trace grows
# with them (on an H100 machine's host: 4.48 s for the CLI's 20-latent GRU
# step, load included, and 13.66 s for 10 transformer latents; at 100,
# the README's serving example, 37.38 s and 102.67 s; PERF.md §6). These
# counts keep the phase short and are not a serving workload: the push
# time depends on them. A push of 1 s (100 latents) is 5 or 10 calls
EXPORT_LATENTS = {"tpu_fast": 20, "transformer_fast": 10}
OPERATOR_FNS = {f for f in vars(__import__("operator")).values()
                if callable(f)}


def graph_is_plain(ep) -> list:
    """The call targets of an exported graph that are not aten, prims or
    operator functions (none, for an artifact with no kernel in it)."""
    out = []
    for n in ep.graph.nodes:
        if n.op != "call_function":
            continue
        t = n.target
        if isinstance(t, torch._ops.OpOverload):
            if t.namespace not in ("aten", "prims"):
                out.append(str(t))
        elif t not in OPERATOR_FNS:
            out.append(str(t))
    return out


def counted_launches(fn):
    """(fn(), the kernels' launches during it), every count set to 0
    just before."""
    for f in COUNTED.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in COUNTED.items() if f.launches}


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of fn() with a CUDA sync around each call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase25a_extractor(card: str, workdir: str, root: str) -> None:
    """The extractor artifact of phase 20's workdir through the eval CLI on
    the card (symbolic batch), run on CUDA at 64 x 20 480 and B = 1 and on
    the CPU, against the live model; its extraction rate beside the live
    one."""
    path = os.path.join(root, "extractor.pt2")
    row, counts, wall = eval_cli_run(["--workdir", workdir, "--device",
                                      "cuda", "--export-model", path])
    with open(path + ".json") as f:
        side = json.load(f)
    print(f"export (a): python -m cpc_tpu_torch.eval --export-model on "
          f"{card}: {json.dumps(row)} in {wall:.2f} s (the CLI's wall: "
          f"config, checkpoint, trace of the plain path with a symbolic "
          f"batch, save); sidecar kernels {side['kernels']!r}, launches "
          f"{counts}", flush=True)
    check(row["checkpoint_step"] == TRAIN_STEPS and not counts
          and side["kernels"] == "plain"
          and row["in_avals"] == ["f32[b,20480]"], f"export row {row}")
    cfg, model = workdir_model(workdir)
    S, B = cfg.data.snippet_samples, cfg.data.batch_size
    x = np.random.default_rng(25).standard_normal((B, S)).astype(
        np.float32) * 0.1
    fn = export.load_artifact(path, "cuda").module()
    bad = graph_is_plain(export.load_artifact(path))
    check(not bad, f"the extractor artifact calls {bad}")

    def live(xb):
        with torch.inference_mode():
            z, c = model.latents(prepare_waveform(xb, cfg.data.normalize))
        return z.float().cpu(), c.float().cpu()

    def art(f, xb):
        with torch.inference_mode():
            z, c = f(xb)
        return z.float().cpu(), c.float().cpu()
    errs = {}
    for rows in (B, 1):
        xb = torch.from_numpy(x[:rows]).cuda()
        (z, c), n_art = counted_launches(lambda: art(fn, xb))
        (zl, cl), n_live = counted_launches(lambda: live(xb))
        check(not n_art and n_live == {"gru_scan": 1},
              f"launches: artifact {n_art}, live {n_live}")
        errs[rows] = ((z - zl).abs().max().item() / zl.abs().max().item(),
                      (c - cl).abs().max().item())
    fn_cpu = export.load_artifact(path, "cpu").module()
    rows = 4
    t0 = time.perf_counter()
    z, c = art(fn_cpu, torch.from_numpy(x[:rows]))
    cpu_s = time.perf_counter() - t0
    zl, cl = live(torch.from_numpy(x[:rows]).cuda())
    errs[f"the CPU at {rows}"] = (
        (z - zl).abs().max().item() / zl.abs().max().item(),
        (c - cl).abs().max().item())
    print("export (a): the artifact against the live model (GRU kernel): "
          + ", ".join(f"B = {k}: z {e[0]:.3e} of max |z| (tol "
                      f"{EXPORT_Z_TOL:.0e}), c {e[1]:.3e} (tol "
                      f"{TOL[torch.bfloat16]:.0e})" for k, e in errs.items())
          + f"; the CPU call {cpu_s:.2f} s on the host of {card}",
          flush=True)
    for k, (ez, ec) in errs.items():
        check(ez <= EXPORT_Z_TOL and ec <= TOL[torch.bfloat16],
              f"artifact vs live ({k}): z {ez}, c {ec}")

    n_batches = 4
    wave = (np.random.default_rng(1).standard_normal(n_batches * B * S)
            * 0.1).astype(np.float32)
    batches = [torch.from_numpy(b).cuda() for b in wave.reshape(
        n_batches, B, S)]
    runs = {   # each over the same 4 device-resident batches, to the host
        "artifact": lambda: [art(fn, xb) for xb in batches],
        "live": lambda: [live(xb) for xb in batches],
        "extract_features": lambda: extract_features(
            model, wave, window=S, batch_windows=B,
            normalize=cfg.data.normalize)}
    for run in runs.values():   # warm-up
        run()
    ms = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]) * 3:
        for k in order:
            ms[k].append(host_ms(runs[k], 1))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True   # torch's default
    try:
        runs["artifact"]()
        ms_tf32 = host_ms(runs["artifact"], 3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    audio = n_batches * B * S / cfg.data.sample_rate
    rate = {k: audio / statistics.median(v) * 1e3 for k, v in ms.items()}
    print(f"export (a): {audio:.2f} audio-s of tpu_fast extraction (batch "
          f"{B}, bf16) on {card}, median of 6 in turns (host clock, CUDA "
          f"sync): the artifact {rate['artifact']:.1f} audio-s/s (its fp32 "
          f"conv products with cuDNN's TF32 off, as this script runs; "
          f"{audio / ms_tf32 * 1e3:.1f} with torch's default "
          f"cudnn.allow_tf32=True, exact on bf16 inputs), the live model's "
          f"latents on the same device-resident batches "
          f"{rate['live']:.1f}, live extract_features (host windowing and "
          f"copies included, phase 4's measure) "
          f"{rate['extract_features']:.1f}", flush=True)


def stream_artifact_run(card: str, name: str, path: str, model,
                        rate: int) -> None:
    """Drives the streaming-step artifact at `path` through the server's
    backend (`serve._ArtifactStream` on the card), under torch's default
    TF32 settings as a server process has them, in pushes of 1 s over
    STREAM_SECONDS of seeded audio: against StreamingExtractor(model) fed
    the same chunks at phase 21's tolerances, no kernel launched, each push
    timed beside the live push."""
    bad = graph_is_plain(export.load_artifact(path))
    check(not bad, f"the {name} step artifact calls {bad}")
    wave = (np.random.default_rng(21).standard_normal(
        STREAM_SECONDS * rate) * 0.1).astype(np.float32)
    with torch_tf32_defaults():
        art = serve._ArtifactStream(path, "cuda")
        z, c, secs, launched, _ = feed(art, wave, rate)
        check(not launched, f"{name} step artifact launched {launched}")
        zl, cl, live_secs, _, _ = feed(StreamingExtractor(model), wave, rate)
    ez, ec = held("z", z, zl[:len(z)]), held("c", c, cl[:len(c)])
    steady, live = (statistics.median(v[1:]) * 1e3
                    for v in (secs, live_secs))
    print(f"export (b): {name} streaming step of {art.n_latents} latents "
          f"(window {art.window}, fp32), {len(z) // art.n_latents} windows "
          f"of {STREAM_SECONDS} s of audio through serve's artifact backend "
          f"with torch's default TF32 settings in force: z {ez:.3e}, c "
          f"{ec:.3e} from StreamingExtractor fed the same {rate}-sample "
          f"chunks (tol rtol 1e-5 + atol 1e-5 / 2e-5), no kernel launched; "
          f"on {card}: a push of 1 s ({rate // art.hop} or so calls, each "
          f"the copy in, the program, the copies out) {steady:.2f} ms "
          f"(first {secs[0] * 1e3:.2f}; median of {len(secs) - 1}, host "
          f"clock) against the live push {live:.2f} ms in the same call",
          flush=True)


def phase25b_streams(card: str, workdir: str, root: str) -> str:
    """Streaming-step artifacts of both gars: the GRU's exported by the CLI
    from phase 20's workdir, the transformer's by `export_streaming_step`
    from a seed-0 transformer_fast model; each driven against
    StreamingExtractor and timed. Returns the GRU artifact's path."""
    path = os.path.join(root, "stream.pt2")
    row, counts, wall = eval_cli_run(
        ["--workdir", workdir, "--device", "cuda", "--export-model", path,
         "--export-streaming", str(EXPORT_LATENTS["tpu_fast"])])
    print(f"export (b): python -m cpc_tpu_torch.eval --export-streaming "
          f"{EXPORT_LATENTS['tpu_fast']} on {card}: {json.dumps(row)} in "
          f"{wall:.2f} s (the CLI's wall), launches {counts}", flush=True)
    check(not counts and row["in_avals"][0] == "f32[1,1,256]",
          f"streaming export {row}, launches {counts}")
    cfg, model = workdir_model(workdir)
    stream_artifact_run(card, "tpu_fast (phase 20's workdir)", path, model,
                        cfg.data.sample_rate)

    cfg = presets.transformer_fast()
    model = CPCModel(cfg.model, device="cuda",
                     generator=torch.Generator().manual_seed(0)).eval()
    tr_path = os.path.join(root, "transformer.pt2")
    t0 = time.perf_counter()
    export.save_artifact(tr_path, export.export_streaming_step(
        model, chunk_latents=EXPORT_LATENTS["transformer_fast"]),
        meta={"config": to_dict(cfg)})
    print(f"export (b): transformer_fast (seed 0) streaming step of "
          f"{EXPORT_LATENTS['transformer_fast']} latents traced and saved "
          f"in {time.perf_counter() - t0:.2f} s on {card}", flush=True)
    stream_artifact_run(card, "transformer_fast (seed 0)", tr_path, model,
                        cfg.data.sample_rate)
    return path


def phase25c_serve(card: str, workdir: str, path: str) -> None:
    """`serve.main --artifact` of phase 20's workdir's streaming step, on i16
    stdin, with torch's default TF32 settings in force: its frames against
    `--workdir`'s and against the same program driven directly at fp32
    (TF32 off) on the same windows."""
    cfg, _ = workdir_model(workdir)
    n = EXPORT_LATENTS["tpu_fast"]
    rate, seconds = cfg.data.sample_rate, 30
    q = np.clip(np.random.default_rng(24).standard_normal(seconds * rate)
                * 3000, -32768, 32767).astype("<i2")
    frames, lines = {}, {}
    for src in (["--artifact", path], ["--workdir", workdir]):
        out, err = io.BytesIO(), StampedText()
        with torch_tf32_defaults():     # a server process's settings
            (rc, launched) = counted_launches(lambda: serve.main(
                [*src, "--emit", "zc", "--in-format", "i16"],
                stdin=io.BytesIO(q.tobytes()), stdout=out, stderr=err))
        check(rc == 0, f"serve {src[0]} returned {rc}")
        key = src[0][2:]
        lines[key] = [json.loads(x) for x in err.getvalue().splitlines()]
        lines[key].append((err.stamp('"frames"') - err.stamp('"frame_dim"'),
                           launched))
        frames[key] = np.frombuffer(out.getvalue(), "<f4").reshape(-1, 768)
    loop_s, launched = lines["artifact"][-1]
    check(not launched, f"serve --artifact launched {launched}")
    check(lines["artifact"][0] == lines["workdir"][0],
          f"headers {lines['artifact'][0]} vs {lines['workdir'][0]}")
    W = 465 + (n - 1) * 160
    hop = n * 160
    windows = (len(q) - W) // hop + 1
    summary = lines["artifact"][-2]
    check(summary == {"frames": windows * n,
                      "dropped_tail_samples": len(q) - windows * hop,
                      "dropped_partial_bytes": 0}, f"summary {summary}")
    fa, fw = frames["artifact"], frames["workdir"][:len(frames["artifact"])]
    ez, ec = held("z", fa[:, :512], fw[:, :512]), held("c", fa[:, 512:],
                                                       fw[:, 512:])
    fn = export.load_artifact(path, "cuda").module()
    h = torch.zeros((1, 1, 256), device="cuda")
    deq = q.astype(np.float32) / 32768.0
    direct = []
    with torch.no_grad(), fp32_exact():     # the program at fp32
        for j in range(windows):
            z, c, h = fn(h, torch.from_numpy(
                deq[None, j * hop:j * hop + W]).cuda())
            direct.append(torch.cat([z[0], c[0]], 1).cpu().numpy())
    check(np.array_equal(fa, np.concatenate(direct)),
          "served frames differ from the program driven directly")
    print(f"export (c): serve --artifact (phase 20's workdir's streaming "
          f"step, {n} latents a call) --emit zc --in-format i16, {seconds} "
          f"audio-s: summary {json.dumps(summary)}, header equal to "
          f"--workdir's; frames bit-equal to the program driven on the "
          f"same windows; against serve --workdir over the {len(fa)} "
          f"frames of complete windows: z {ez:.3e}, c {ec:.3e} (bit-equal: "
          f"{np.array_equal(fa, fw)}; the live path runs the GRU kernel, "
          f"the artifact its plain recurrence); no kernel launched; on "
          f"{card}: the serve loop {loop_s * 1e3:.2f} ms = "
          f"{seconds / loop_s:.1f} audio-s/s, --workdir's "
          f"{lines['workdir'][-1][0] * 1e3:.2f} ms in the same call",
          flush=True)


def phase25_export(card: str, workdir: str) -> None:
    """Phase 25: the serving artifacts, from phase 20's workdir."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        phase25a_extractor(card, workdir, root)
        path = phase25b_streams(card, workdir, root)
        phase25c_serve(card, workdir, path)
        print(f"export: phase 25 in {time.perf_counter() - t0:.1f} s",
              flush=True)


# ------------------------------------------------ data parallelism, N cards
DP_CARDS_STEPS = {"fp32": 10, "bf16": 30}
FP32_SETS = ["--set", "model.dtype=float32",
             "--set", "model.loss.pallas_bf16=false"]
# fp32, N NCCL ranks against one process: the same global batches through
# kernels at other batch sizes (16 rows against 64), so the sums differ in
# order, and the updates carry that on. Held over the first DP_CARDS_HELD
# steps; measured on 4 H100 80GB HBM3 at 700 W: 7.9e-7 to 1.8e-6 there,
# then growing as the loss falls, 2.0e-5 by step 8 and 6.0e-4 by step 19.
DP_CARDS_TOL, DP_CARDS_HELD = 1e-5, 5


def dp_collectives_main(argv) -> None:
    """One rank of `--dp-cards`' look at the DP layer alone:
    `chip_smoke.py --dp-collectives-rank R --dp-port P --dp-world N
    [--dp-device cpu]`. On a world of N (NCCL on the cards; gloo with
    `--dp-device cpu`, a rehearsal) at dp_global_negatives' sizes, the
    median ms (host clock, a sync after each call) of the gather forward
    and backward of a rank's z (64/N, 128, 512) bf16, the gradients'
    average (7.4 M fp32), the host group's any_true, and the data-parallel
    step on the rank's 64/N rows, device-resident; then 20 steps in a row
    with one sync at the end, as the trainer runs them: alone, with the
    host group's any_true after each, and with each batch from a Batcher
    over `--dp-corpus` too (the trainer's loop); rank 0 prints them as one
    JSON line."""
    args = dict(zip(argv[::2], argv[1::2]))
    rank, world = int(args["--dp-collectives-rank"]), int(args["--dp-world"])
    mesh = multihost.initialize(f"127.0.0.1:{args['--dp-port']}", world,
                                rank, device=args.get("--dp-device", "cuda"),
                                timeout=300)
    try:
        dev = mesh.device
        cfg = presets.dp_global_negatives()
        rows = cfg.data.batch_size // world

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def ms(fn, reps=10, warmup=3):
            for _ in range(warmup):
                fn()
            times = []
            for _ in range(reps):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)
        gen = torch.Generator(device=dev).manual_seed(rank)
        z = torch.randn((rows, 128, 512), device=dev, generator=gen).to(
            torch.bfloat16).requires_grad_()
        pool, _ = dp.gather_pool(z, mesh)
        g = torch.randn(pool.shape, device=dev, generator=gen).to(
            torch.bfloat16)
        model = init_state(cfg, dev)
        grads = [torch.randn(p.shape, device=dev, generator=gen)
                 for p in model.parameters()]
        steps = make_step_fns(cfg, model, mesh)
        batch = torch.from_numpy(multihost.shard_batch(dp_batch(cfg), mesh))
        batch = batch.to(dev)
        out = {"world": world, "rows": rows, "device": str(dev),
               "gather_forward_ms": ms(lambda: dp.gather_pool(z, mesh)),
               "gather_backward_ms": ms(lambda: torch.autograd.grad(
                   pool, z, g, retain_graph=True)),
               "average_ms": ms(lambda: dp.average(grads, mesh)),
               "any_true_ms": ms(lambda: multihost.any_true(False, mesh),
                                 reps=50),
               "step_ms": ms(lambda: steps.train_step(batch))}
        ds = SnippetDataset(args["--dp-corpus"], cfg.data.snippet_samples)
        feed = iter(Batcher(ds, cfg.data.batch_size, seed=0))

        def loop(agree: bool, fed: bool, n: int = 20) -> float:
            sync()
            t0 = time.perf_counter()
            for _ in range(n):
                b = batch
                if fed:
                    b = to_device(multihost.shard_batch(next(feed)[2], mesh),
                                  dev)
                steps.train_step(b)
                if agree:
                    multihost.any_true(False, mesh)
            sync()
            return (time.perf_counter() - t0) * 1e3 / n
        for _ in range(10):  # one epoch of the corpus into its cache
            next(feed)
        out.update(run_ms=loop(False, False),
                   run_any_true_ms=loop(True, False),
                   run_batcher_ms=loop(True, True))
        feed.close()
        if rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        multihost.shutdown()


def dp_cards_main(n: int) -> None:
    """`chip_smoke.py --dp-cards N`: data parallelism across N cards under
    NCCL, what one card cannot run. dp_global_negatives through the
    training CLI on N processes (one a card, `--coordinator`) against one
    process on the global batch of 64: in fp32 the losses of the first
    DP_CARDS_HELD steps within DP_CARDS_TOL (relative), the rest printed;
    in bf16 the trainer's audio-s/s of both (its log windows of 10 steps,
    the first holding the warm-up)."""
    check(torch.cuda.is_available() and torch.cuda.device_count() >= n,
          f"--dp-cards {n} needs {n} CUDA GPUs")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"gpus: {cards.strip().splitlines()}", flush=True)
    _build.load_library()  # once, before the ranks start
    # (label, steps, processes, environment): fp32 for the trajectory,
    # bf16 for the rate, and bf16 on N cards with a thread a core in every
    # process (OMP_NUM_THREADS set, so `multihost.share_host_threads`
    # leaves it), against the default of one a process
    every_core = str(os.cpu_count())
    plan = [("fp32", DP_CARDS_STEPS["fp32"], 1, {}),
            ("fp32", DP_CARDS_STEPS["fp32"], n, {}),
            ("bf16", DP_CARDS_STEPS["bf16"], 1, {}),
            ("bf16", DP_CARDS_STEPS["bf16"], n, {}),
            (f"bf16 OMP_NUM_THREADS={every_core}", DP_CARDS_STEPS["bf16"], n,
             {"OMP_NUM_THREADS": every_core})]
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        corpus = os.path.join(root, "corpus")
        generate_synthetic_corpus(corpus, num_speakers=64,
                                  files_per_speaker=3, seconds_per_file=4.0,
                                  seed=0)
        for i, (label, steps, procs, env) in enumerate(plan):
            wd = os.path.join(root, str(i))
            cmd = [sys.executable, "-m", "cpc_tpu_torch.train",
                   "--config", "dp_global_negatives", "--data", corpus,
                   "--workdir", wd, "--steps", str(steps), "--set",
                   f"train.log_every={1 if label == 'fp32' else 10}",
                   *(FP32_SETS if label == "fp32" else [])]
            port = free_port()
            cmds = [cmd] if procs == 1 else [
                cmd + ["--coordinator", f"127.0.0.1:{port}",
                       "--num-processes", str(procs), "--process-id",
                       str(r)] for r in range(procs)]
            t0 = time.perf_counter()
            run_ranks(cmds, timeout=900, env=env)
            with open(os.path.join(wd, "metrics.jsonl")) as f:
                runs[label, procs] = [json.loads(line) for line in f]
            print(f"dp cards: {label}, {procs} process(es), {steps} steps "
                  f"in {time.perf_counter() - t0:.1f} s (start-up "
                  f"included)", flush=True)
            if label.startswith("bf16"):
                windows = [(r["step"], round(r["audio_sec_per_sec"], 1),
                            round(r["steps_per_sec"], 2), round(r["loss"], 6))
                           for r in runs[label, procs]]
                print(f"dp cards: {label} dp_global_negatives on {procs} "
                      f"card(s) ({cards.splitlines()[0]}), the trainer's "
                      f"windows of 10 steps (step, audio-s/s, steps/s, "
                      f"loss): {windows}", flush=True)
        # the DP layer alone, on N cards and on one, with NCCL's own
        # account of the transport it chose
        for world in (n, 1):
            port = free_port()
            texts = run_ranks(
                [[sys.executable, os.path.abspath(__file__),
                  "--dp-collectives-rank", str(r), "--dp-port", str(port),
                  "--dp-world", str(world), "--dp-corpus", corpus]
                 for r in range(world)],
                timeout=600, env={"NCCL_DEBUG": "INFO"})
            said = [line for line in texts[0].splitlines()
                    if " via " in line or "NCCL version" in line
                    or "NET/" in line][:4]
            result = [line for line in texts[0].splitlines()
                      if line.startswith("{")]
            print(f"dp cards: the DP layer alone on {world} card(s), rank 0 "
                  f"(ms, host clock): {result[-1] if result else None}; "
                  f"NCCL says: {said}", flush=True)
    one, many = runs["fp32", 1], runs["fp32", n]
    errs = [abs(b["loss"] - a["loss"]) / abs(a["loss"])
            for a, b in zip(one, many)]
    check(len(one) == len(many) == DP_CARDS_STEPS["fp32"], "fp32 records")
    held = max(errs[:DP_CARDS_HELD])
    print(f"dp cards: fp32, {n} NCCL ranks x {64 // n} rows vs one process "
          f"on 64: losses {[r['loss'] for r in many]} vs "
          f"{[r['loss'] for r in one]}; relative errors by step "
          f"{[f'{e:.1e}' for e in errs]}, the first {DP_CARDS_HELD} held: "
          f"{held:.3e} (tol {DP_CARDS_TOL:.0e})", flush=True)
    check(held <= DP_CARDS_TOL, f"fp32 trajectory error {held}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------- phase 26
# (a) loss.ring under data parallelism: dp_global_negatives on the
# all-steps pool, swept round the ranks. The JAX chooser refuses none of
# the preset's other loss flags with all_steps (the fused heads are taken
# for same_step only), so use_pallas, pallas_bf16 and fuse_heads stay: the
# ring itself is fp32 tensor code whatever they say, and the gathered step
# it is held against runs the all-steps kernels on the bf16 wire.
RING_DP_SETS = ["model.loss.negatives=all_steps"]
RING_DP_WORLDS = (2, 4)
# (b)-(d) the CP step: its loss is always the ring's fp32 all-steps sweep,
# so the loss knobs it would ignore go back to their defaults (it refuses
# them otherwise, as the JAX package does)
CP_SETS = ["model.loss.negatives=all_steps", "model.loss.use_pallas=false",
           "model.loss.pallas_bf16=false", "model.loss.fuse_heads=false"]
CP_WATCHED = ("gar.block0.attn.query.weight", "gar.in_proj.weight",
              "prediction_heads.weight", "encoder.conv4.weight")
# the CP cells: (batch, samples, ranks)
CP_CELLS = [(64, 20_480, 1), (64, 20_480, 2), (64, 20_480, 4),
            (8, 163_840, 4)]
CP_FP32_RANKS = 4
CP_TIMED_STEPS = 5
CP_CLI_STEPS = 10
# The bf16 CP step against the single-device all-steps step with
# attn_impl=flash, the kernels whose numerics are the ring's (fp32 scores
# and P on bf16 q, k, v, the output rounded once to bf16), and the plain
# fp32 all-steps loss, the ring loss's own arithmetic: the two differ in
# fp32 summation order and in where an activation rounds to bf16, as phase
# 13's two steps do, and held at its tolerances but one: each rank's
# weight gradient rounds to bf16 before the ranks' fp32 sum (as a DP
# rank's dz does, phase 23(b)), so an entry below 1 may move by one bf16
# rounding, 2**-8 (measured on an H100 80GB HBM3 at 700 W: the encoder's
# last conv at R = 4, 1.25e-3).
CP_BF16_TOL = dict(TRANSFORMER_STEP_TOL, grad=4e-3)
# The all-steps kernels round delta = softmax - onehot to bf16, their
# tensor cores' operand (`allsteps_nll_backward_reference`), where the ring
# keeps it fp32, as the JAX ring does: in a bf16 model the kernels' step
# then differs from the plain step by that rounding, carried on by the
# heads and the gar into every gradient (measured on an H100 80GB HBM3 at
# 700 W: 6 % of the heads' largest gradient under dp_global_negatives). A
# ring step is held against the kernels' step at the plain step's own
# distance from it (measured in the same run on the same inputs) plus the
# ring's tolerance against the plain step (`banded`).
# fp32 with TF32 off, at transformer_gar's widths: the JAX package's CP
# tolerances (tests/test_ring_attention.py): loss 1e-5 relative with 1e-6
# absolute, gradients 5e-5 relative with 5e-5 absolute; the accuracy
# within one row a k of the single-device run (a near-tie may fall the
# other way when the sums run in another order).
CP_FP32_TOL = {"loss": (1e-5, 1e-6), "grad": (5e-5, 5e-5)}


def on_thread_ranks(world: int, ctx: int, fn, model: int = 1) -> list:
    """fn(mesh) on `world` ranks played by threads on cuda:0, ctx (or
    model) of them to a data row."""
    meshes = thread_meshes(world, "cuda:0", ctx=ctx, timeout=600,
                           model=model)
    return run_thread_ranks(groups_of(meshes),
                            [functools.partial(fn, m) for m in meshes],
                            timeout=1200)


def one_step(cfg, mesh, batch, watched, timed_steps=0):
    """One train step of a model of `cfg` (weights from train.seed) on
    `batch`: its metrics and the watched gradients that the update used
    (the ranks' sum or mean, as the step makes it), on the host; then, with
    `timed_steps`, that many more steps' median ms (CUDA sync; under a
    mesh every rank steps together)."""
    model = init_state(cfg, "cuda")
    steps = make_step_fns(cfg, model, mesh)
    seen = {}
    update = steps.optimizer.step

    def spy(grads):
        seen.update({k: grads[k].detach().float().cpu() for k in watched})
        update(grads)
    steps.optimizer.step = spy
    m = steps.train_step(batch)
    metrics = {k: v.float().cpu() for k, v in m.items()}
    steps.optimizer.step = update
    times = []
    for _ in range(timed_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return metrics, seen, statistics.median(times) if times else None


def step_errors(got, want) -> dict:
    """Phase 7's errors of a step (metrics, grads) against another."""
    (m, g), (w, wg) = got, want
    errs = {"loss": abs(m["loss"].item() - w["loss"].item())
            / abs(w["loss"].item()),
            "acc": (m["acc"] - w["acc"]).abs().max().item(),
            "grad_norm": abs(m["grad_norm"].item() - w["grad_norm"].item())
            / w["grad_norm"].item()}
    for k in wg:
        errs[f"grad {k}"] = rel_err(g[k], wg[k])
        errs[f"grad_of_max {k}"] = rel_to_max(g[k], wg[k])
    return errs


def banded(errs_plain: dict, tols: dict) -> dict:
    """A bound for each error: the plain step's own error against the
    kernels' step, plus `tols`."""
    return {k: e + tols[k.split()[0]] for k, e in errs_plain.items()}


def held_errors(label: str, errs: dict, tols: dict) -> None:
    print(f"{label}: errors {errs} (tolerances {tols})", flush=True)
    for k, e in errs.items():
        bound = tols[k] if k in tols else tols[k.split()[0]]
        check(math.isfinite(e) and e <= bound, f"{label}: {k} error {e}")


def counts_now() -> dict:
    return {k: fn.launches for k, fn in COUNTED.items()}


def zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def phase26a_ring_dp(card: str) -> dict:
    """loss.ring under data parallelism: dp_global_negatives with the
    all-steps pool swept round R = 2 and 4 thread ranks on the card, bf16,
    batch 64, against the same ranks gathering the pool: through the
    all-steps kernels (the preset's use_pallas) and on the plain fp32 loss
    (use_pallas=false, the ring's own arithmetic): loss, per-k accuracy,
    grad_norm and the watched gradients at phase 23(b)'s DP_TOL against
    the plain step, and against the kernels' at the plain step's own
    distance from them plus DP_TOL (`banded`). Returns the ring run's
    launches a rank."""
    per_rank = {}
    for world in RING_DP_WORLDS:
        runs = {}
        for label, sets in (("ring", ["model.loss.ring=true"]),
                            ("gathered, kernels", []),
                            ("gathered, plain", ["model.loss.use_pallas="
                                                 "false"])):
            cfg = apply_overrides(presets.dp_global_negatives(),
                                  RING_DP_SETS + sets)
            batch = torch.from_numpy(dp_batch(cfg)).cuda()
            zero_counts()
            res = on_thread_ranks(world, 1, lambda mesh: one_step(
                cfg, mesh, batch[mesh.rows(len(batch))], DP_WATCHED)[:2])
            runs[label] = res, counts_now()
        ring_res, ring_n = runs["ring"]
        kern_n = runs["gathered, kernels"][1]
        want = {k: world for k in GRU_KERNELS}
        print(f"ring dp (a): {world} thread ranks on cuda:0, "
              f"dp_global_negatives + {RING_DP_SETS} (use_pallas, "
              f"pallas_bf16 and fuse_heads kept: the JAX chooser refuses "
              f"none of them with all_steps), loss.ring true; loss "
              f"{ring_res[0][0]['loss'].item():.6f}; launches, ring "
              f"{ {k: v for k, v in ring_n.items() if v} }, gathered "
              f"through the kernels {  {k: v for k, v in kern_n.items() if v} }",
              flush=True)
        check(all(ring_n[k] == n for k, n in want.items())
              and not any(v for k, v in ring_n.items() if k not in want),
              f"ring dp launches {ring_n}")
        check(kern_n["allsteps_nll_forward"] == world
              and kern_n["allsteps_nll_backward"] == world,
              f"gathered all-steps launches {kern_n}")
        plain, kernels = (runs[k][0] for k in ("gathered, plain",
                                              "gathered, kernels"))
        for r, got in enumerate(ring_res):
            held_errors(f"ring dp (a) rank {r} of {world} vs gathered, "
                        f"plain", step_errors(got, plain[r]), DP_TOL)
            band = banded(step_errors(plain[r], kernels[r]), DP_TOL)
            held_errors(f"ring dp (a) rank {r} of {world} vs gathered, "
                        f"kernels (bound: the plain step's error + DP_TOL)",
                        step_errors(got, kernels[r]), band)
        per_rank = {k: n // world for k, n in ring_n.items()}
    return per_rank


def cp_config(base: str, impl: str, batch: int, samples: int, ctx: int,
              extra=()):
    shape = ["train.parallel=cp"] if ctx else []
    return apply_overrides(presets.by_name(base), [
        *CP_SETS, f"model.ar.attn_impl={impl}", f"data.batch_size={batch}",
        f"data.snippet_samples={samples}", *shape, *extra])


def cp_run(cfg, ranks: int, ctx: int, batch, timed_steps=0):
    """The CP step of `cfg` on `ranks` ranks (one NCCL rank for 1, else
    threads on cuda:0), ctx to a data row; rank 0's result."""
    if ranks == 1:
        mesh = multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                    device="cuda")
        try:
            check(dist.get_backend() == "nccl", "one NCCL rank")
            return one_step(cfg, mesh, batch, CP_WATCHED, timed_steps)
        finally:
            multihost.shutdown()
    return on_thread_ranks(ranks, ctx, lambda mesh: one_step(
        cfg, mesh, batch, CP_WATCHED, timed_steps))[0]


def phase26b_cp(card: str) -> dict:
    """Context parallelism at transformer_fast's widths, ring and zigzag,
    bf16, against the single-device all-steps step with attn_impl=flash on
    the same seeded batch: on the plain fp32 loss (the ring's arithmetic)
    at CP_BF16_TOL, and through the all-steps kernels at the plain step's
    distance from them plus CP_BF16_TOL;
    then at transformer_gar's widths in fp32 with TF32 off. Returns the CP
    runs' launches (none: the ring is plain)."""
    cp_counts = {}
    for B, S, R in CP_CELLS:
        refs = {label: cp_config("transformer_fast", "flash", B, S, 0, sets)
                for label, sets in (
                    ("kernels", ["model.loss.use_pallas=true",
                                 "model.loss.pallas_bf16=true"]),
                    ("plain", []))}
        batch = torch.from_numpy(np.clip(np.random.default_rng(3)
                                         .standard_normal((B, S)) * 3000,
                                         -32768, 32767).astype(np.int16)
                                 ).cuda()
        zero_counts()
        ref = {"kernels": one_step(refs["kernels"], None, batch, CP_WATCHED,
                                   CP_TIMED_STEPS)}
        ref_n = counts_now()
        check(ref_n["allsteps_nll_forward"] == 1 + CP_TIMED_STEPS,
              f"reference launches {ref_n}")
        ref["plain"] = one_step(refs["plain"], None, batch, CP_WATCHED)
        for impl in ("ring", "zigzag"):
            cfg = cp_config("transformer_fast", impl, B, S, R)
            zero_counts()
            got = cp_run(cfg, R, R, batch, CP_TIMED_STEPS)
            n = counts_now()
            cp_counts = {k: cp_counts.get(k, 0) + v for k, v in n.items()}
            label = (f"cp (b) {impl}, {B} x {S} (T {S // 160}), R = {R} "
                     f"({'one NCCL rank' if R == 1 else 'thread ranks'}), "
                     f"bf16")
            held_errors(f"{label} vs one device, plain loss",
                        step_errors(got[:2], ref["plain"][:2]), CP_BF16_TOL)
            band = banded(step_errors(ref["plain"][:2], ref["kernels"][:2]),
                          CP_BF16_TOL)
            held_errors(f"{label} vs one device, the kernels' loss (bound: "
                        f"the plain step's error + CP_BF16_TOL)",
                        step_errors(got[:2], ref["kernels"][:2]), band)
            print(f"{label} on {card}: the CP step {got[2]:.2f} ms against "
                  f"the single-device step's {ref['kernels'][2]:.2f} ms "
                  f"(attention and all-steps kernels; median of "
                  f"{CP_TIMED_STEPS} each, CUDA sync, timed in turns; "
                  f"thread ranks share one card, so this is the ring's "
                  f"cost, not a speed-up); kernels launched by the CP runs "
                  f"{ {k: v for k, v in n.items() if v} }", flush=True)
            check(not any(n.values()), f"the CP step launched {n}")
        ref_again = one_step(refs["kernels"], None, batch, CP_WATCHED,
                             CP_TIMED_STEPS)
        print(f"cp (b) {B} x {S}: the single-device step again "
              f"{ref_again[2]:.2f} ms on {card}", flush=True)
    # fp32 at transformer_gar's widths, TF32 off (main() turns it off)
    B, S = presets.transformer_gar().data.batch_size, 20_480
    ref_cfg = cp_config("transformer_gar", "xla", B, S, 0)
    batch = torch.from_numpy(np.clip(np.random.default_rng(4).standard_normal(
        (B, S)) * 3000, -32768, 32767).astype(np.int16)).cuda()
    ref = one_step(ref_cfg, None, batch, CP_WATCHED)
    for impl in ("ring", "zigzag"):
        got = cp_run(cp_config("transformer_gar", impl, B, S, CP_FP32_RANKS),
                     CP_FP32_RANKS, CP_FP32_RANKS, batch)
        fp32_held(f"cp (b) {impl} fp32 transformer_gar {B} x {S}, R = "
                  f"{CP_FP32_RANKS}", got[:2], ref[:2], B * (S // 160 - 12))
    return cp_counts


def fp32_held(label: str, got, want, rows_per_k: int) -> None:
    """An fp32 CP result against one device at the JAX package's CP
    tolerances (loss, grad_norm and gradients), the accuracy within one
    row a k."""
    (m, g), (w, wg) = got, want
    (lr, la), (gr, ga) = CP_FP32_TOL["loss"], CP_FP32_TOL["grad"]
    errs = {"loss": abs(m["loss"].item() - w["loss"].item()),
            "grad_norm": abs(m["grad_norm"].item()
                             - w["grad_norm"].item()),
            "acc": (m["acc"] - w["acc"]).abs().max().item()}
    bounds = {"loss": la + lr * abs(w["loss"].item()),
              "grad_norm": ga + gr * abs(w["grad_norm"].item()),
              "acc": 1.0 / rows_per_k}
    for k in wg:
        errs[f"grad {k}"] = ((g[k] - wg[k]).abs()
                             - gr * wg[k].abs()).max().item()
        bounds[f"grad {k}"] = ga
    print(f"{label} (TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cuDNN {torch.backends.cudnn.allow_tf32}): loss "
          f"{m['loss'].item():.7f} vs {w['loss'].item():.7f}; |error| "
          f"(for a gradient, |error| - {gr:.0e} |want|) {errs} against "
          f"{bounds}", flush=True)
    for k, e in errs.items():
        check(math.isfinite(e) and e <= bounds[k], f"{label}: {k} {e}")


def phase26c_dpcp(card: str) -> None:
    """DP x CP on 2 x 2 thread ranks at transformer_gar's widths, fp32:
    audio -> loss (cp_cpc_loss_from_audio, every parameter's gradient),
    the full step, and the step with augmentation, each against one
    device."""
    B, S = presets.transformer_gar().data.batch_size, 20_480
    rows = B * (S // 160 - 12)
    dpcp = ["train.parallel=dpcp", "train.mesh_shape=2,2",
            "train.mesh_axes=data,ctx"]
    batch = torch.from_numpy(np.clip(np.random.default_rng(5).standard_normal(
        (B, S)) * 3000, -32768, 32767).astype(np.int16)).cuda()
    cfg = cp_config("transformer_gar", "ring", B, S, 0, dpcp)
    ref_cfg = cp_config("transformer_gar", "xla", B, S, 0)
    # audio -> loss: every parameter's gradient, no update
    ref_model = init_state(ref_cfg, "cuda")
    ref_loss, ref_m = make_step_fns(ref_cfg, ref_model).loss_fn(ref_model,
                                                                batch)
    ref_loss.backward()
    want = ({"loss": ref_loss.detach().cpu(), "acc": ref_m["acc"].cpu(),
             "grad_norm": global_norm(p.grad for p in ref_model.parameters()
                                      ).cpu()},
            {k: p.grad.cpu() for k, p in ref_model.named_parameters()})

    def audio_loss(mesh):
        model = init_state(cfg, "cuda")
        x = cp.shard(device_prepare(batch, cfg.data.normalize), mesh, "ctx",
                     "data")
        loss, m = cp.cp_cpc_loss_from_audio(model, x, mesh=mesh,
                                            dp_axis="data")
        with torch.autograd.set_multithreading_enabled(False):
            loss.backward()
        return loss.detach().cpu(), m["acc"].cpu(), {
            k: p.grad.cpu() for k, p in model.named_parameters()}
    res = on_thread_ranks(4, 2, audio_loss)
    grads = {k: sum(r[2][k] for r in res) for k in res[0][2]}
    got = ({"loss": res[0][0], "acc": res[0][1],
            "grad_norm": global_norm(grads.values())}, grads)
    fp32_held("dpcp (c) audio -> loss, 2 x 2 thread ranks", got, want, rows)
    for aug in (False, True):
        extra = ["data.augment=true"] if aug else []
        got = on_thread_ranks(4, 2, lambda mesh: one_step(
            apply_overrides(cfg, extra), mesh, batch, CP_WATCHED))[0]
        ref = one_step(apply_overrides(ref_cfg, extra), None, batch,
                       CP_WATCHED)
        fp32_held(f"dpcp (c) the full step{' with augmentation' * aug}, "
                  f"2 x 2 thread ranks", got[:2], ref[:2], rows)


def phase26d_cli(card: str) -> None:
    """train.parallel=cp through the training CLI at a world of one:
    transformer_fast's widths, CP_CLI_STEPS steps (finite metrics, no
    kernel launched: the CP path is plain), then 5 + 5 resumed, bit-equal
    under the CLI's own cuDNN settings."""
    sets = [a for s in CP_SETS + ["train.parallel=cp",
                                  "model.ar.attn_impl=ring",
                                  "train.log_every=1"]
            for a in ("--set", s)]
    with tempfile.TemporaryDirectory() as root:
        straight, resumed = (os.path.join(root, n) for n in ("a", "b"))
        train_cli_run("train.parallel=cp", "transformer_fast", sets,
                      CP_CLI_STEPS, {}, workdir=straight)
        corpus = os.path.join(straight, "synthetic_corpus")
        for steps, extra in ((5, []), (CP_CLI_STEPS, ["--resume"])):
            rc = train_cli.main(["--config", "transformer_fast", "--data",
                                 corpus, "--workdir", resumed, "--steps",
                                 str(steps), *sets, *extra])
            check(rc == 0, f"cp cli leg of {steps} steps returned {rc}")
        ckpts, differ, worst = resumed_against_straight(straight, resumed)
        print(f"cp (d): {CP_CLI_STEPS} CLI steps straight vs 5 + "
              f"{CP_CLI_STEPS - 5} resumed (train.parallel=cp, world 1, "
              f"{cudnn_settings()}): step {CP_CLI_STEPS} checkpoints' "
              f"tensors that differ: {differ}, largest absolute difference "
              f"{worst:.3e}", flush=True)
        check(not differ and ckpts[0]["meta"] == ckpts[1]["meta"],
              f"the resumed CP run's checkpoint differs: {differ}")


def phase26_cp(card: str) -> tuple:
    """Phase 26: the ring InfoNCE under DP, context parallelism, DP x CP,
    the CLI. Returns (ring DP launches a rank, CP launches)."""
    ring_dp = phase26a_ring_dp(card)
    cp_counts = phase26b_cp(card)
    phase26c_dpcp(card)
    phase26d_cli(card)
    return ring_dp, cp_counts


# ---------------------------------------------------------------- phase 27
# the three fp32 presets no phase trained: their data and the kernels a
# training step launches once each (the GRU always runs gru_scan; the plain
# loss and attention launch none)
A11_PRESETS = {"baseline": ("synthetic", GRU_KERNELS),
               "maestro_scalogram": ("synthetic-music", GRU_KERNELS),
               "transformer_gar": ("synthetic", ())}
# One fp32 step on the card against the same step on the CPU, TF32 off:
# the same arithmetic in another summation order (cuDNN's and cuBLAS's
# against oneDNN's and MKL's; the GRU kernel against its plain recurrence):
# loss and grad_norm relative, gradients relative to max(1, max |grad|)
# and to their largest entry, the accuracy within one row a k. The first
# conv's weight gradient is a sum of B x T_out = 32 768 products an entry,
# and a reordered sum of n fp32 terms may move by about n x 2**-24 = 2e-3
# of their scale (measured on an H100 80GB HBM3 at 700 W: 1.3e-3 to 1.7e-3
# of the largest entry): grad_of_max takes phase 7's 1e-2.
A11_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grad": 1e-4,
           "grad_of_max": 1e-2, "acc": 1.0}


A11_PAIRS = 10  # pairs of turns, alternating which goes first
A11_TIMED = 3   # steps a turn


def a11_step(cfg, device, batch, watched):
    """One training step through the program's own step function (as the
    CLI runs it: an fp32 model with TF32 off, `utils.precision`): its
    metrics and the watched gradients the update used, on the host."""
    model = init_state(cfg, device)
    steps = make_step_fns(cfg, model)
    seen = {}
    steps.optimizer.step = lambda grads: seen.update(
        {k: grads[k].detach().float().cpu() for k in watched})
    m = steps.train_step(batch.to(device))
    return ({"loss": m["loss"].float().cpu(), "acc": m["acc"].float().cpu(),
             "grad_norm": m["grad_norm"].float().cpu()}, seen)


def a11_step_ms(cfg, batch) -> dict:
    """The fp32 step's ms on the card under torch's default TF32 settings,
    as a user's process runs it: "after" is the step as it is (TF32 off
    inside it), "before" the same step with its precision context made a
    no-op (cuDNN's convs in TF32, as before C15's repair). A11_PAIRS pairs
    of turns, alternating which goes first, A11_TIMED steps a turn (a
    warm-up step each before the first pair); returns each label's turn
    medians, pair by pair."""
    runs = {}
    for label in ("after", "before"):
        model = init_state(cfg, "cuda")
        runs[label] = make_step_fns(cfg, model)
    batch = batch.cuda()
    times = {"after": [], "before": []}
    noop = (lambda dtype: contextlib.nullcontext())
    for i in range(A11_PAIRS):
        for label in (("after", "before") if i % 2 == 0
                      else ("before", "after")):
            with contextlib.ExitStack() as stack:
                if label == "before":
                    stack.enter_context(forced("exact_for", noop,
                                               module=train_step_module))
                if i == 0:
                    runs[label].train_step(batch)  # warm-up
                turn = []
                for _ in range(A11_TIMED):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runs[label].train_step(batch)
                    torch.cuda.synchronize()
                    turn.append((time.perf_counter() - t0) * 1e3)
                times[label].append(statistics.median(turn))
    return times


def tf32_cost(times: dict) -> str:
    """TF32-off's cost a step from a11_step_ms' pairs: each label's median
    and range over its turns, the pairs' differences, and whether they
    resolve it (every pair's difference of one sign) or not."""
    diff = [a - b for a, b in zip(times["after"], times["before"])]
    same = all(d > 0 for d in diff) or all(d < 0 for d in diff)
    return (f"{statistics.median(times['after']):.2f} ms with TF32 off "
            f"inside the step (turns {min(times['after']):.2f}-"
            f"{max(times['after']):.2f}), "
            f"{statistics.median(times['before']):.2f} ms with cuDNN's TF32 "
            f"convs, before C15's repair (turns {min(times['before']):.2f}-"
            f"{max(times['before']):.2f}); TF32 off minus TF32 by pair: "
            f"median {statistics.median(diff):+.2f} ms, from "
            f"{min(diff):+.2f} to {max(diff):+.2f}: "
            f"{'resolved, one sign in every pair' if same else 'UNRESOLVED, the pairs differ in sign'}"
            f" ({len(diff)} pairs of turns of {A11_TIMED} steps, "
            f"alternating, CUDA sync)")


def phase27_fp32_presets(card: str) -> dict:
    """A11: baseline (batch 8), maestro_scalogram and transformer_gar, fp32,
    through the training CLI for 10 steps (finite metrics, launches
    counted), an extraction through the eval CLI from that workdir, and one
    step on the card against the same step on the CPU, under torch's
    default TF32 settings as a user's process has them (the step turns
    TF32 off for an fp32 model itself, C15), at A11_TOL, and that step run
    twice bit-equal (C16); then the step's time against the same step with
    cuDNN's TF32 convs, in alternating pairs (tf32_cost). Returns the
    launches of the three CLI runs, summed."""
    total = {k: 0 for k in COUNTED}
    for name, (data, kernels) in A11_PRESETS.items():
        cfg = presets.by_name(name)
        with tempfile.TemporaryDirectory() as wd:
            n = train_cli_run(f"A11 {name}", name, [], TRAIN_STEPS,
                              {k: 1 for k in kernels}, workdir=wd, data=data)
            total = {k: total[k] + n[k] for k in total}
            wav = os.path.join(wd, "x.wav")
            write_wav(wav, np.random.default_rng(6).standard_normal(
                4 * cfg.data.snippet_samples).astype(np.float32) * 0.1,
                cfg.data.sample_rate)
            out = os.path.join(wd, "features.npz")
            line, got, wall = eval_cli_run(["--extract", wav, "--workdir", wd,
                                            "--out", out])
            with np.load(out) as f:
                feats = {k: f[k] for k in f.files}
            shapes = {k: v.shape for k, v in feats.items()}
            print(f"A11 {name}: extraction through the eval CLI in "
                  f"{wall:.2f} s: {line}; arrays {shapes}; launches {got}",
                  flush=True)
            check(line["checkpoint_step"] == TRAIN_STEPS
                  and all(np.isfinite(v).all() for v in feats.values()),
                  f"A11 {name} extraction: {line}")
            check(set(got) == set(kernels[:1]),
                  f"A11 {name} extraction launched {got}")
        B, S = cfg.data.batch_size, cfg.data.snippet_samples
        batch = torch.from_numpy(np.clip(np.random.default_rng(7)
                                         .standard_normal((B, S)) * 3000,
                                         -32768, 32767).astype(np.int16))
        names = [k for k, _ in init_state(cfg).named_parameters()]
        # the first encoder weight, the gar's first weight, the heads'
        watched = [next(k for k in names if k.startswith(part)
                        and k.endswith(("weight", "wh")))
                   for part in ("encoder.", "gar.")] + [
            "prediction_heads.weight"]
        cpu = a11_step(cfg, "cpu", batch, watched)
        T = S // cfg.model.encoder.total_downsample
        rows = B * (T - cfg.model.loss.prediction_steps)
        with torch_tf32_defaults():
            flags = (f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
                     f"cuDNN {torch.backends.cudnn.allow_tf32}, cuDNN "
                     f"deterministic {torch.backends.cudnn.deterministic}")
            card_step = a11_step(cfg, "cuda", batch, watched)
            again = a11_step(cfg, "cuda", batch, watched)
            with forced("_Repeatable", _CudnnDefault, module=conv_cuda):
                before = [a11_step(cfg, "cuda", batch, watched)
                          for _ in range(2)]
            ms = a11_step_ms(cfg, batch)
        errs = step_errors(card_step, cpu)
        errs["acc"] = round(errs["acc"] * rows, 3)  # rows a k
        held_errors(f"A11 {name}: one step on the card under torch's "
                    f"default settings ({flags}) vs the CPU", errs, A11_TOL)
        # C16: the same step twice gives the same bits (the first conv's
        # weight gradient summed with atomics did not)
        differ = [k for k in watched
                  if not torch.equal(card_step[1][k], again[1][k])] + [
            k for k in card_step[0]
            if not torch.equal(card_step[0][k], again[0][k])]
        spread = {k: float((before[0][1][k] - before[1][1][k]).abs().max())
                  for k in watched
                  if not torch.equal(before[0][1][k], before[1][1][k])}
        print(f"A11 {name}: the step run twice on the card, metrics and "
              f"watched gradients that differ: {differ}; with cuDNN's "
              f"default conv backward (C16's repair taken out, reported) "
              f"{spread or 'none'}", flush=True)
        check(not differ, f"A11 {name}: the fp32 step is not reproducible: "
              f"{differ}")
        print(f"A11 {name}: the fp32 step on {card}, batch {B}, under "
              f"torch's defaults: {tf32_cost(ms)}", flush=True)
    c16_repeat(card)
    return total


# C16: the step where run-to-run fp32 bits were first seen to differ (the
# --hosts rehearsal's dp_global_negatives in fp32, at its 32 rows a rank
# and at the 64 of one process)
C16_ROWS = (32, 64)


class _CudnnDefault:
    """`conv_cuda._Repeatable` replaced by cuDNN's own conv with its
    default backward algorithms: the convs before C16's repair."""

    @staticmethod
    def apply(h, w, b, stride):
        conv = (torch.nn.functional.conv1d if h.dim() == 3
                else torch.nn.functional.conv2d)
        return conv(h, w, b, stride=stride)


def c16_repeat(card: str) -> None:
    """The fp32 dp_global_negatives step twice from the same seed on the
    same batch under torch's default settings: as the program runs it
    (the first conv's backward with cuDNN's deterministic algorithms,
    `conv_cuda._Repeatable`), every gradient bit-equal; with cuDNN's
    default algorithms for it instead, the gradients that differ and by
    how much, reported."""
    for rows in C16_ROWS:
        cfg = apply_overrides(presets.dp_global_negatives(), [
            "model.dtype=float32", "model.loss.pallas_bf16=false",
            f"data.batch_size={rows}"])
        batch = torch.from_numpy(dp_batch(cfg))
        names = [k for k, _ in init_state(cfg).named_parameters()]
        with torch_tf32_defaults():
            runs = [a11_step(cfg, "cuda", batch, names) for _ in range(2)]
            with forced("_Repeatable", _CudnnDefault, module=conv_cuda):
                before = [a11_step(cfg, "cuda", batch, names)
                          for _ in range(2)]
        differ = [k for k in names if not torch.equal(runs[0][1][k],
                                                      runs[1][1][k])]
        spread = {k: float((before[0][1][k] - before[1][1][k]).abs().max())
                  for k in names
                  if not torch.equal(before[0][1][k], before[1][1][k])}
        print(f"C16: fp32 dp_global_negatives, {rows} rows, the step twice on "
              f"{card} under torch's defaults: gradients that differ {differ}"
              f"; with cuDNN's default algorithms for the first conv's "
              f"backward (the repair taken out, reported) {spread or 'none'}",
              flush=True)
        check(not differ, f"C16: the fp32 step at {rows} rows is not "
              f"reproducible: {differ}")


# ---------------------------------------------------------------- phase 28
# Tensor parallelism (parallel/tp.py) on one card, ranks played by threads:
# tpu_fast at full width (bf16, 64 x 20 480, K 12, ar.use_pallas) on the
# (data, model) meshes below against the single-device step on the plain
# loss, the TP step's own (the JAX package's TP step computes the plain
# InfoNCE whatever loss.use_pallas says); then transformer_fast's widths in
# fp32 (TF32 off) with xla and flash16 attention (the flash kernels on
# each rank's heads).
TP_MESHES = ((1, 2), (2, 2), (1, 4))
TP_TRANSFORMER_MESHES = ((1, 2), (1, 4))
TP_PLAIN = ["model.loss.use_pallas=false"]
TP_WATCHED = ("encoder.conv0.weight", "gar.layer0.wi",
              "prediction_heads.weight")
TP_TRANSFORMER_WATCHED = ("encoder.conv0.weight",
                          "gar.block0.attn.query.weight",
                          "gar.block0.attn.out.weight",
                          "gar.block0.fc2.weight", "prediction_heads.weight")
TP_TIMED_STEPS = 3
# bf16 TP against one device: the convs and heads compute the whole
# product on the gathered weight, as one device does, but the GRU's wi
# partials are summed in fp32 and rounded once where the single-device
# product rounds its bf16 output, and a data axis splits the rows, where
# cuDNN and cuBLAS may pick another algorithm: an entry near a rounding
# edge lands one bf16 rounding apart, as two DP ranks' do (phase 23(b)).
TP_BF16_TOL = dict(DP_TOL)
_TRAFFIC = threading.local()


def _timed_all_reduce(real):
    """Ring.all_reduce, timed between CUDA syncs and counted in bytes for
    the thread (or process) that set `_TRAFFIC.rec`."""
    def call(self, t):
        rec = getattr(_TRAFFIC, "rec", None)
        if rec is None:
            return real(self, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(self, t)
        torch.cuda.synchronize()
        rec["ms"] += (time.perf_counter() - t0) * 1e3
        rec["bytes"] += t.numel() * t.element_size() if self.size > 1 else 0
        rec["calls"] += self.size > 1
    return call


def tp_one_step(cfg, mesh, batch, watched, timed_steps=0):
    """One TP step of a model of `cfg` (weights from train.seed, sharded)
    on this rank's rows of `batch`: its metrics and the whole watched
    gradients the update used, on the host; with `timed_steps`, that many
    more steps' median ms (CUDA sync; every rank steps together), and one
    more step with its TP collectives (Ring.all_reduce) timed and counted:
    {bytes, ms, calls} a rank."""
    model = init_state(cfg, "cuda")
    steps = tp.make_tp_train_step(cfg, model, mesh)
    seen = {}
    update = steps.optimizer.step

    def spy(grads):
        seen.update({k: grads[k] for k in watched})
        update(grads)
    steps.optimizer.step = spy
    rows = batch[mesh.rows(len(batch))]
    m = steps.train_step(rows)
    steps.optimizer.step = update
    metrics = {k: v.float().cpu() for k, v in m.items()}
    grads = {k: v.float().cpu()
             for k, v in tp.gather_params(model, mesh, seen).items()}
    times, traffic = [], None
    for _ in range(timed_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.train_step(rows)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if timed_steps:
        _TRAFFIC.rec = traffic = {"bytes": 0, "ms": 0.0, "calls": 0}
        try:
            steps.train_step(rows)
        finally:
            _TRAFFIC.rec = None
    return (metrics, grads, statistics.median(times) if times else None,
            traffic)


def tp_config(base: str, sets=()):
    return apply_overrides(presets.by_name(base), TP_PLAIN + list(sets))


def tp_run(cfg, shape, batch, watched, timed_steps):
    """tp_one_step on d x m thread ranks on the card; rank 0's result and
    every kernel's launches in the run (counts zeroed before)."""
    d, m = shape
    zero_counts()
    with forced("all_reduce", _timed_all_reduce(Ring.all_reduce),
                module=Ring):
        got = on_thread_ranks(d * m, 1, lambda mesh: tp_one_step(
            cfg, mesh, batch, watched, timed_steps), model=m)[0]
    return got, counts_now()


def phase28_tp(card: str) -> dict:
    """Tensor parallelism on one card, ranks played by threads: tpu_fast
    at full width on TP_MESHES against the single-device plain step
    (TP_BF16_TOL: loss, per-k accuracy, grad_norm and the gathered
    gradients of conv0, wi and the heads), the GRU kernels once a rank a
    step; then transformer_fast's widths in fp32 on TP_TRANSFORMER_MESHES
    with xla and flash16 attention against the single-device step at the
    JAX package's CP tolerances (fp32_held). Each TP step's ms beside the
    single-device step's (in turns) and a step's TP collectives (bytes,
    ms) a rank. Returns the kernels' launches in the TP runs."""
    total = {k: 0 for k in COUNTED}
    steps_run = 1 + TP_TIMED_STEPS + 1  # checked, timed, the traffic's
    cfg = tp_config("tpu_fast")
    batch = torch.from_numpy(dp_batch(cfg)).cuda()
    ref = one_step(cfg, None, batch, TP_WATCHED, TP_TIMED_STEPS)
    for shape in TP_MESHES:
        (m, g, ms, traffic), n = tp_run(cfg, shape, batch, TP_WATCHED,
                                         TP_TIMED_STEPS)
        total = {k: total[k] + n[k] for k in total}
        world = shape[0] * shape[1]
        label = (f"tp tpu_fast bf16 64 x 20 480 on (data, model) = {shape}, "
                 f"thread ranks")
        held_errors(f"{label} vs the single-device plain step",
                    step_errors((m, g), ref[:2]), TP_BF16_TOL)
        print(f"{label} on {card}: the TP step {ms:.2f} ms a rank (median "
              f"of {TP_TIMED_STEPS}) against the single-device step's "
              f"{ref[2]:.2f} ms (thread ranks share one card: the split's "
              f"and the collectives' cost, not a speed-up); a step's TP "
              f"collectives on rank 0: {traffic['calls']} all_reduces, "
              f"{traffic['bytes'] / 1e6:.1f} MB, {traffic['ms']:.2f} ms "
              f"(between CUDA syncs, waits for the other ranks included); "
              f"launches {({k: v for k, v in n.items() if v})}",
              flush=True)
        for name in GRU_KERNELS:
            check(n[name] == world * steps_run,
                  f"{label}: {name} launched {n[name]} times, expected "
                  f"{world * steps_run} (once a rank a step)")
        torch.cuda.empty_cache()
    ref_again = one_step(cfg, None, batch, TP_WATCHED, TP_TIMED_STEPS)
    print(f"tp tpu_fast: the single-device step again {ref_again[2]:.2f} ms "
          f"on {card}", flush=True)
    for impl in ("xla", "flash16"):
        cfg = tp_config("transformer_fast", ["model.dtype=float32",
                                             f"model.ar.attn_impl={impl}"])
        B, S = cfg.data.batch_size, cfg.data.snippet_samples
        batch = torch.from_numpy(dp_batch(cfg)).cuda()
        ref = one_step(cfg, None, batch, TP_TRANSFORMER_WATCHED,
                       TP_TIMED_STEPS)
        for shape in TP_TRANSFORMER_MESHES:
            (m, g, ms, traffic), n = tp_run(cfg, shape, batch,
                                             TP_TRANSFORMER_WATCHED,
                                             TP_TIMED_STEPS)
            total = {k: total[k] + n[k] for k in total}
            label = (f"tp transformer_fast fp32 {impl} {B} x {S} on (data, "
                     f"model) = {shape}, thread ranks")
            fp32_held(f"{label} vs one device", (m, g), ref[:2],
                      B * (S // 160 - cfg.model.loss.prediction_steps))
            attn = {k: n[k] for k in ATTN_KERNELS if n[k]}
            print(f"{label} on {card}: the TP step {ms:.2f} ms a rank "
                  f"against the single-device step's {ref[2]:.2f} ms; TP "
                  f"collectives on rank 0: {traffic['calls']} all_reduces, "
                  f"{traffic['bytes'] / 1e6:.1f} MB, {traffic['ms']:.2f} ms; "
                  f"attention kernels launched {attn}", flush=True)
            check(bool(attn) == (impl == "flash16"),
                  f"{label}: attention kernels {attn}")
            torch.cuda.empty_cache()
    return total


# ------------------------------------------------- --tp-cards N, --hosts 2
TP_CARDS_STEPS = 5
HOSTS_STEPS = 8


def tp_rank_main(argv) -> None:
    """One NCCL rank of `chip_smoke.py --tp-cards N`, one process a card:
    the tpu_fast TP step (bf16, full width) on (1, N) and (2, N/2) and the
    fp32 transformer_fast step (flash16) on (1, N), each against the
    single-device plain step on this rank's own card (TP_BF16_TOL, and the
    JAX package's CP tolerances in fp32), its median ms beside the
    single-device step's, and a step's collectives timed one by one between
    CUDA syncs. Rank 0 prints one JSON line a case."""
    args = dict(zip(argv[::2], argv[1::2]))
    rank, world = int(args["--tp-rank"]), int(args["--tp-world"])
    base = multihost.initialize(f"127.0.0.1:{args['--tp-port']}", world,
                                rank, device="cuda")
    try:
        plan = [("tpu_fast", [], (1, world), TP_WATCHED),
                ("tpu_fast", [], (2, world // 2), TP_WATCHED),
                ("transformer_fast", ["model.dtype=float32",
                                      "model.ar.attn_impl=flash16"],
                 (1, world), TP_TRANSFORMER_WATCHED)]
        meshes = {}
        for name, sets, shape, watched in plan:
            if shape[1] not in meshes:
                meshes[shape[1]] = multihost.with_model(base, shape[1])
            mesh = meshes[shape[1]]
            cfg = tp_config(name, sets)
            batch = torch.from_numpy(dp_batch(cfg)).to(mesh.device)
            ref = one_step(cfg, None, batch, watched, TP_CARDS_STEPS)
            with forced("all_reduce", _timed_all_reduce(Ring.all_reduce),
                        module=Ring):
                zero_counts()
                m, g, ms, traffic = tp_one_step(cfg, mesh, batch, watched,
                                                TP_CARDS_STEPS)
                n = counts_now()
            ref_again = one_step(cfg, None, batch, watched, TP_CARDS_STEPS)
            label = " ".join([name, *sets, f"on {shape}"])
            if cfg.model.dtype == "float32":
                fp32_held(f"tp cards {label}", (m, g), ref[:2],
                          len(batch) * (cfg.data.snippet_samples // 160
                                        - cfg.model.loss.prediction_steps))
            else:
                held_errors(f"tp cards {label}", step_errors((m, g), ref[:2]),
                            TP_BF16_TOL)
            if rank == 0:
                print(json.dumps({
                    "case": label, "world": world, "tp_ms": ms,
                    "one_card_ms": [ref[2], ref_again[2]],
                    "collectives": traffic, "launches": {
                        k: v for k, v in n.items() if v}}), flush=True)
    finally:
        multihost.shutdown()


def tp_cards_main(n: int) -> None:
    """`chip_smoke.py --tp-cards N`: tensor parallelism across N cards
    under NCCL, one process a card (`tp_rank_main`)."""
    check(torch.cuda.is_available() and torch.cuda.device_count() >= n
          and n % 2 == 0, f"--tp-cards {n} needs an even {n} CUDA GPUs")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"gpus: {cards.strip().splitlines()}", flush=True)
    _build.load_library()  # once, before the ranks start
    port = free_port()
    texts = run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
          "--tp-port", str(port), "--tp-world", str(n)] for r in range(n)],
        timeout=900)
    for t in texts:
        for line in t.splitlines():
            if line.startswith("tp cards") or line.startswith("{"):
                print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def hosts_main(n_hosts: int) -> None:
    """`chip_smoke.py --hosts 2`: a rehearsal of a run across hosts on one
    machine. Each "host" is one process launched as torchrun launches a
    host's rank, under env:// with its own RANK, LOCAL_RANK 0,
    LOCAL_WORLD_SIZE 1 and CUDA_VISIBLE_DEVICES (its one card), through the
    training CLI (--distributed), dp_global_negatives in fp32, against one
    process on the global batch: the losses of the first DP_CARDS_HELD
    steps within DP_CARDS_TOL; then a resume in fresh processes, bit for
    bit against the straight run."""
    check(torch.cuda.is_available() and torch.cuda.device_count() >= n_hosts,
          f"--hosts {n_hosts} needs {n_hosts} CUDA GPUs")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"gpus: {cards.strip().splitlines()}", flush=True)
    _build.load_library()
    with tempfile.TemporaryDirectory() as root:
        corpus = os.path.join(root, "corpus")
        generate_synthetic_corpus(corpus, num_speakers=64,
                                  files_per_speaker=3, seconds_per_file=4.0,
                                  seed=0)

        def run(wd, steps, procs, *extra):
            cmd = [sys.executable, "-m", "cpc_tpu_torch.train", "--config",
                   "dp_global_negatives", "--data", corpus, "--workdir", wd,
                   "--steps", str(steps), "--set", "train.log_every=1",
                   "--set", f"train.checkpoint_every={HOSTS_STEPS // 2}",
                   *FP32_SETS, *extra]
            if procs == 1:
                return run_ranks([cmd], timeout=900)
            port = free_port()
            logs = [tempfile.TemporaryFile("w+") for _ in range(procs)]
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(procs),
                       LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
            ps = [subprocess.Popen(cmd + ["--distributed"], stdout=log,
                                   stderr=subprocess.STDOUT, text=True,
                                   env=dict(env, RANK=str(r),
                                            CUDA_VISIBLE_DEVICES=str(r)))
                  for r, log in enumerate(logs)]
            deadline = time.monotonic() + 900
            try:
                while any(p.poll() is None for p in ps):
                    if any(p.returncode not in (None, 0) for p in ps) \
                            or time.monotonic() > deadline:
                        break
                    time.sleep(0.1)
            finally:
                for p in ps:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
            texts = []
            for r, (p, log) in enumerate(zip(ps, logs)):
                log.seek(0)
                texts.append(log.read())
                log.close()
                check(p.returncode == 0, f"host {r} exited {p.returncode}:"
                      f"\n{texts[-1][-6000:]}")
            return texts

        def losses(wd):
            with open(os.path.join(wd, "metrics.jsonl")) as f:
                return [r["loss"] for r in map(json.loads, f)
                        if r["prefix"] == "train"]
        one, straight, resumed = (os.path.join(root, k)
                                  for k in ("one", "straight", "resumed"))
        t0 = time.perf_counter()
        run(one, HOSTS_STEPS, 1)
        t1 = time.perf_counter()
        said = run(straight, HOSTS_STEPS, n_hosts)
        t2 = time.perf_counter()
        run(resumed, HOSTS_STEPS // 2, n_hosts)
        run(resumed, HOSTS_STEPS, n_hosts, "--resume")
        a, b = losses(one), losses(straight)
        errs = [abs(y - x) / abs(x) for x, y in zip(a, b)]
        held = max(errs[:DP_CARDS_HELD])
        print(f"hosts: dp_global_negatives fp32 on {n_hosts} \"hosts\" of "
              f"one rank (env://, LOCAL_WORLD_SIZE 1, a card each; "
              f"{cards.splitlines()[0]}) vs one process: "
              f"{HOSTS_STEPS} steps in {t2 - t1:.1f} s against "
              f"{t1 - t0:.1f} s (start-up included); relative errors by "
              f"step {[f'{e:.1e}' for e in errs]}, the first "
              f"{DP_CARDS_HELD} held: {held:.3e} (tol {DP_CARDS_TOL:.0e}); "
              f"rank 0 said {[l for l in said[0].splitlines() if 'processes=' in l]}",
              flush=True)
        check(len(b) == HOSTS_STEPS and held <= DP_CARDS_TOL,
              f"hosts trajectory {errs}")
        ck = [torch.load(os.path.join(w, "checkpoints",
                                      f"step_{HOSTS_STEPS}.pt"))
              for w in (straight, resumed)]
        differ = [k for k, v in ck[0]["model"].items()
                  if not torch.equal(v, ck[1]["model"][k])]
        print(f"hosts: resumed at step {HOSTS_STEPS // 2} in fresh "
              f"processes: losses {losses(resumed) == b}, checkpoint "
              f"tensors that differ {differ}", flush=True)
        check(losses(resumed) == b and not differ
              and ck[0]["meta"] == ck[1]["meta"], "the resumed run differs")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ------------------------------------------------------------ --cp-cards N
CP_CARDS_STEPS = 8
# fp32, N NCCL ranks against one process through the CLI: the same
# arithmetic in another order (the ring's chunked sums, the halo convs over
# shards), held over the first CP_CARDS_HELD steps as --dp-cards holds its
# trajectory.
CP_CARDS_TOL, CP_CARDS_HELD = 1e-5, 5


def cp_p2p_main(argv) -> None:
    """One rank of `--cp-cards`' look at the ring's transport:
    `chip_smoke.py --cp-p2p-rank R --cp-port P --cp-world N`. A CP step of
    transformer_fast's widths (bf16, 64 x 20 480, ring attention) over N
    NCCL ranks, one a card: the step's median ms, then one step with every
    ring transfer and the gradients' all_reduce timed between two CUDA
    syncs. Prints one JSON line."""
    from cpc_tpu_torch.ops.ring_util import Ring
    args = dict(zip(argv[::2], argv[1::2]))
    rank, world = int(args["--cp-p2p-rank"]), int(args["--cp-world"])
    mesh = multihost.initialize(f"127.0.0.1:{args['--cp-port']}", world,
                                rank, device="cuda")
    try:
        cfg = cp_config("transformer_fast", "ring", 64, 20_480, world)
        batch = torch.from_numpy(dp_batch(cfg)).to(mesh.device)
        model = init_state(cfg, mesh.device)
        steps = make_step_fns(cfg, model, mesh)
        for _ in range(3):
            steps.train_step(batch)
        times = []
        for _ in range(CP_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps.train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        spent = {"permute": [], "all_reduce": [], "bytes": 0}
        real_permute, real_sum = Ring.permute, Ring.all_reduce

        def timed(kind, real):
            def call(self, x, *rest):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(self, x, *rest)
                torch.cuda.synchronize()
                spent[kind].append((time.perf_counter() - t0) * 1e3)
                if kind == "permute":
                    spent["bytes"] += x.numel() * x.element_size()
                return out
            return call
        Ring.permute = timed("permute", real_permute)
        Ring.all_reduce = timed("all_reduce", real_sum)
        try:
            steps.train_step(batch)
        finally:
            Ring.permute, Ring.all_reduce = real_permute, real_sum
        print(json.dumps({
            "rank": rank, "world": world, "step_ms": statistics.median(times),
            "transfers": len(spent["permute"]),
            "p2p_ms": sum(spent["permute"]),
            "all_reduces": len(spent["all_reduce"]),
            "all_reduce_ms": sum(spent["all_reduce"]),
            "p2p_bytes": spent["bytes"]}), flush=True)
    finally:
        multihost.shutdown()


def cp_cards_main(n: int) -> None:
    """`chip_smoke.py --cp-cards N`: context parallelism across N cards
    under NCCL. transformer_gar (fp32, all-steps) through the training CLI
    on N processes, one a card, with train.parallel=cp (ctx N) and then
    dpcp (2 x N/2), against one process's ordinary step on the same
    batches: the losses of the first CP_CARDS_HELD steps within
    CP_CARDS_TOL (relative); then the ring's P2P time a step of a bf16
    transformer_fast CP step on the N cards (`cp_p2p_main`)."""
    check(torch.cuda.is_available() and torch.cuda.device_count() >= n
          and n % 2 == 0, f"--cp-cards {n} needs an even {n} CUDA GPUs")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"gpus: {cards.strip().splitlines()}", flush=True)
    _build.load_library()  # once, before the ranks start
    sets = [a for s in CP_SETS + ["train.log_every=1"] for a in ("--set", s)]
    plan = [("one process, train.parallel=dp", 1, []),
            ("train.parallel=cp", n, ["--set", "train.parallel=cp"]),
            ("train.parallel=dpcp", n,
             ["--set", "train.parallel=dpcp", "--set",
              f"train.mesh_shape=2,{n // 2}", "--set",
              "train.mesh_axes=data,ctx"])]
    losses = {}
    with tempfile.TemporaryDirectory() as root:
        corpus = os.path.join(root, "corpus")
        generate_synthetic_corpus(corpus, num_speakers=8,
                                  files_per_speaker=3, seconds_per_file=4.0,
                                  seed=0)
        for i, (label, procs, extra) in enumerate(plan):
            wd = os.path.join(root, str(i))
            cmd = [sys.executable, "-m", "cpc_tpu_torch.train", "--config",
                   "transformer_gar", "--data", corpus, "--workdir", wd,
                   "--steps", str(CP_CARDS_STEPS), *sets, *extra]
            port = free_port()
            cmds = [cmd] if procs == 1 else [
                cmd + ["--coordinator", f"127.0.0.1:{port}",
                       "--num-processes", str(procs), "--process-id",
                       str(r)] for r in range(procs)]
            t0 = time.perf_counter()
            run_ranks(cmds, timeout=900)
            with open(os.path.join(wd, "metrics.jsonl")) as f:
                losses[label] = [r["loss"] for r in map(json.loads, f)
                                 if r["prefix"] == "train"]
            print(f"cp cards: {label}, {procs} process(es), "
                  f"{CP_CARDS_STEPS} steps in {time.perf_counter() - t0:.1f}"
                  f" s (start-up included); losses {losses[label]}",
                  flush=True)
        one = losses[plan[0][0]]
        for label, _, _ in plan[1:]:
            errs = [abs(b - a) / abs(a) for a, b in zip(one, losses[label])]
            held = max(errs[:CP_CARDS_HELD])
            print(f"cp cards: fp32 transformer_gar, {label} on {n} NCCL "
                  f"ranks vs one process: relative errors by step "
                  f"{[f'{e:.1e}' for e in errs]}, the first {CP_CARDS_HELD} "
                  f"held: {held:.3e} (tol {CP_CARDS_TOL:.0e})", flush=True)
            check(len(losses[label]) == CP_CARDS_STEPS
                  and held <= CP_CARDS_TOL, f"{label} trajectory {errs}")
    port = free_port()
    texts = run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--cp-p2p-rank", str(r),
          "--cp-port", str(port), "--cp-world", str(n)] for r in range(n)],
        timeout=600)
    said = [json.loads(line) for t in texts for line in t.splitlines()
            if line.startswith("{")]
    print(f"cp cards: the ring on {n} cards ({cards.splitlines()[0]}), a "
          f"bf16 transformer_fast CP step (64 x 20 480, ring attention): "
          f"each rank's step ms, and its transfers, their bytes and ms and "
          f"the gradients' all_reduce ms in one step timed transfer by "
          f"transfer between CUDA syncs: {said}", flush=True)
    check(len(said) == n, f"{len(said)} ranks reported")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))



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

        # 23. data parallelism: a one-rank NCCL step against the step, two
        # gloo ranks on the card against one process, the kernels at the
        # per-rank shapes, the CLI with a resume
        phase23a_one_rank(card)
        dp_launches = phase23b_two_ranks(card)
        dp_ms = phase23c_kernels(card, measured)
        cli_counts = phase23d_cli(card)
        dp_launches.update({k: cli_counts[k] for k in GRU_KERNELS
                            + HEADS_KERNELS})

        # 24. the data feed and the trainer's side features: resampling,
        # FLAC, packing, --packed --device-corpus --augment through the
        # CLI, the two feeds against each other, augmentation, the
        # supervisor, profiling and nan-debug
        feed_launches = phase24_feed(card)

        # 25. export: the extractor artifact of phase 20's workdir on the
        # card and on the CPU, the streaming steps of both gars, serve
        # --artifact
        phase25_export(card, workdir)

    # 26. the ring InfoNCE under DP, context parallelism (ring and zigzag,
    # one NCCL rank and thread ranks on the card, bf16 and fp32), DP x CP
    # on 2 x 2 thread ranks, train.parallel=cp through the CLI
    ring_dp_launches, cp_launches = phase26_cp(card)

    # 27. the three fp32 presets no phase trained (A11)
    a11_launches = phase27_fp32_presets(card)

    # 28. tensor parallelism on thread ranks: tpu_fast at full width, the
    # transformer's heads (xla and flash16) in fp32
    tp_launches = phase28_tp(card)

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
        "launches": counts[name], **{k: measured[name][k] for k in keys},
        "dp_launches": dp_launches.get(name, 0), "dp_ms": dp_ms.get(name),
        "feed_launches": feed_launches[name],
        "ring_dp_launches": ring_dp_launches[name],
        "cp_launches": cp_launches[name], "a11_launches": a11_launches[name],
        "tp_launches": tp_launches[name]}
        for name, (src, tpu) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if "--dp-rank" in sys.argv:
        dp_rank_main(sys.argv[1:])
    elif "--dp-collectives-rank" in sys.argv:
        dp_collectives_main(sys.argv[1:])
    elif "--dp-cards" in sys.argv:
        dp_cards_main(int(sys.argv[sys.argv.index("--dp-cards") + 1]))
    elif "--cp-p2p-rank" in sys.argv:
        cp_p2p_main(sys.argv[1:])
    elif "--cp-cards" in sys.argv:
        cp_cards_main(int(sys.argv[sys.argv.index("--cp-cards") + 1]))
    elif "--tp-rank" in sys.argv:
        tp_rank_main(sys.argv[1:])
    elif "--tp-cards" in sys.argv:
        tp_cards_main(int(sys.argv[sys.argv.index("--tp-cards") + 1]))
    elif "--hosts" in sys.argv:
        hosts_main(int(sys.argv[sys.argv.index("--hosts") + 1]))
    else:
        main()
