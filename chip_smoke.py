#!/usr/bin/env python3
"""Drives the PyTorch port (cpc_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, in order; any failure exits non-zero:

1. device: a CUDA GPU is required; prints its name and power limit as
   nvidia-smi reports them;
2. build: compiles cpc_tpu_torch/csrc/*.cu with nvcc for sm_90a;
3. kernel vs plain: the CUDA `gru_scan` against `gru_scan_reference` on the
   same CUDA tensors, at the slice's shape (T, B, H) = (128, 64, 256) in
   bf16 and fp32 and at a ragged (7, 3, 40); then both times at the
   slice's shape in bf16 (median of CUDA-event-timed runs), with
   torch.nn.GRU (cuDNN; it also does the input projection) for context;
4. the extraction slice: `extract_features` of a `tpu_fast` CPCModel (full
   width, random weights from a seed) over 4 batches of 64 windows of
   seeded synthetic audio; checks shapes, finiteness, the kernel's launch
   count, and c against the same model with the plain recurrence; prints
   the extraction throughput;
5. the training kernels against their plain versions on the same CUDA
   tensors: the GRU backward at the slice's (128, 64, 256) and at
   (7, 3, 40), the fused heads + InfoNCE forward and backward at the
   slice's (T, B, C, K, D) = (128, 64, 64, 12, 512) and at (20, 3, 6, 3, 40)
   with shift 3, each in bf16 and fp32; then kernel and plain times at the
   slice's shape in bf16;
6. the training slice through its entry point:
   `cpc_tpu_torch.train.cli.main` trains `tpu_fast` at full width on the
   synthetic corpus for 10 steps; checks that metrics.jsonl is finite, that
   each of the four kernels launched once per step, and that a checkpoint
   was written;
7. one full-width step on a seeded batch through the kernels against the
   same step composed here from the model's modules and the plain
   versions: loss, per-k accuracy, grad_norm and the grads of wh and of the
   heads' weight; then the steady training rate.

It prints a JSON line of the kernels it checked and, last, one JSON object
naming the device.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from cpc_tpu_torch import CPCModel, extract_features, presets
from cpc_tpu_torch.data.loader import device_prepare
from cpc_tpu_torch.ops import _build
from cpc_tpu_torch.ops.dsp import prepare_waveform
from cpc_tpu_torch.ops.gru_cuda import (_GruScanPlain, gru_scan,
                                        gru_scan_backward,
                                        gru_scan_backward_reference,
                                        gru_scan_reference)
from cpc_tpu_torch.ops.infonce_fused import (_HeadsNllPlain,
                                             heads_nll_backward,
                                             heads_nll_backward_reference,
                                             heads_nll_forward,
                                             heads_nll_reference,
                                             reduce_heads_nll)
from cpc_tpu_torch.train import cli as train_cli
from cpc_tpu_torch.train.train_step import (global_norm, init_state,
                                            make_step_fns)

TOL = {torch.float32: 1e-4,   # fp32 with TF32 off: summation order only
       torch.bfloat16: 2e-2}  # bf16 rounding of h and wh over 128 steps
SLICE_SHAPE = (128, 64, 256)  # (T, B, H) of tpu_fast
CASES = [(SLICE_SHAPE, torch.bfloat16), (SLICE_SHAPE, torch.float32),
         ((7, 3, 40), torch.float32), ((7, 3, 40), torch.bfloat16)]


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


def cuda_ms(fn, reps=20, warmup=3):
    """Median over `reps` runs of fn's CUDA-event time, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


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
HEADS_CASES = [(HEADS_SLICE, torch.bfloat16), (HEADS_SLICE, torch.float32),
               ((20, 3, 6, 3, 40, 3), torch.bfloat16),
               ((20, 3, 6, 3, 40, 3), torch.float32)]


def rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


def heads_inputs(T, B, C, K, D, dtype, seed):
    """Seeded p (T, B, K*D), z_tm (T, C, D) and a cotangent (T, K*B)."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((T, B, K * D)) / np.sqrt(D)
    z = rng.standard_normal((T, C, D))
    g = rng.standard_normal((T, K * B)) / (T * B)

    def dev(a, dt):
        return torch.from_numpy(a).to("cuda", dt).contiguous()
    return dev(p, dtype), dev(z, dtype), dev(g, torch.float32)


def phase5_kernels(card: str) -> dict:
    """Backward GRU and fused heads kernels against their plain versions;
    returns {name: (max abs err, ms, plain ms)}."""
    errs = {"gru_scan_backward": 0.0, "heads_nll_forward": 0.0,
            "heads_nll_backward": 0.0}
    with torch.inference_mode():
        for n, ((T, B, H), dtype) in enumerate(GRU_BWD_CASES):
            xp, wh, bh, h0 = gru_inputs(T, B, H, dtype, seed=10 + n)
            g = torch.from_numpy(np.random.default_rng(20 + n).standard_normal(
                (T, B, H))).to("cuda", dtype)
            hs = gru_scan_reference(xp, wh, bh, h0)
            got = gru_scan_backward(xp, wh, bh, h0, hs, g)
            want = gru_scan_backward_reference(xp, wh, bh, h0, hs, g)
            torch.cuda.synchronize()
            for name, a, b in zip(("dxproj", "dwh", "dbh", "dh0"), got, want):
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"gru bwd {name}: {a.dtype} {tuple(a.shape)}")
                check(bool(torch.isfinite(a.float()).all()),
                      f"gru bwd {name} non-finite")
                err = rel_err(a, b)
                tol = REL_TOL[torch.float32 if b.dtype == torch.float32
                              else dtype]
                abs_err = (a.float() - b.float()).abs().max().item()
                errs["gru_scan_backward"] = max(errs["gru_scan_backward"],
                                                abs_err)
                print(f"gru_scan_backward vs plain {(T, B, H)} "
                      f"{str(dtype)[6:]} {name}: max abs err {abs_err:.3e}, "
                      f"relative to max(1, max |plain|) {err:.3e} "
                      f"(tol {tol:.0e})", flush=True)
                check(err <= tol, f"gru bwd {name} error {err} > {tol}")

        for n, ((T, B, C, K, D, shift), dtype) in enumerate(HEADS_CASES):
            p, z, g = heads_inputs(T, B, C, K, D, dtype, seed=30 + n)
            nll, cor, lse = heads_nll_forward(p, z, shift, K)
            r_nll, r_cor, r_lse = heads_nll_reference(p, z, shift, K)
            torch.cuda.synchronize()
            err = max((nll - r_nll).abs().max().item(),
                      (lse - r_lse).abs().max().item())
            miss = (cor != r_cor).float().mean().item()
            errs["heads_nll_forward"] = max(errs["heads_nll_forward"], err)
            print(f"heads_nll_forward vs plain {(T, B, C, K, D)} shift "
                  f"{shift} {str(dtype)[6:]}: nll/lse max abs err {err:.3e} "
                  f"(tol {NLL_TOL:.0e}), argmax mismatch share {miss:.2e} "
                  f"(tol {MISMATCH_TOL:.0e})", flush=True)
            check(err <= NLL_TOL and miss <= MISMATCH_TOL,
                  f"heads fwd error {err}, mismatch {miss}")
            check(bool(torch.isfinite(nll).all()), "heads fwd non-finite")
            dz, dp = heads_nll_backward(g, r_lse, p, z, shift, K)
            r_dz, r_dp = heads_nll_backward_reference(g, r_lse, p, z, shift, K)
            torch.cuda.synchronize()
            for name, a, b, tol in (("dz", dz, r_dz, REL_TOL[torch.float32]),
                                    ("dp", dp, r_dp, REL_TOL[dtype])):
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"heads bwd {name}: {a.dtype} {tuple(a.shape)}")
                err = rel_err(a, b)
                abs_err = (a.float() - b.float()).abs().max().item()
                errs["heads_nll_backward"] = max(errs["heads_nll_backward"],
                                                 abs_err)
                print(f"heads_nll_backward vs plain {(T, B, C, K, D)} "
                      f"{str(dtype)[6:]} {name}: max abs err {abs_err:.3e}, "
                      f"relative to max(1, max |plain|) {err:.3e} "
                      f"(tol {tol:.0e})", flush=True)
                check(err <= tol, f"heads bwd {name} error {err} > {tol}")

        T, B, H = SLICE_SHAPE
        xp, wh, bh, h0 = gru_inputs(T, B, H, torch.bfloat16, seed=10)
        g = torch.randn((T, B, H), device="cuda").to(torch.bfloat16)
        hs = gru_scan_reference(xp, wh, bh, h0)
        args = (xp, wh, bh, h0, hs, g)
        times = {"gru_scan_backward": (
            cuda_ms(lambda: gru_scan_backward(*args)),
            cuda_ms(lambda: gru_scan_backward_reference(*args), reps=5))}
        T, B, C, K, D, shift = HEADS_SLICE
        p, z, g = heads_inputs(T, B, C, K, D, torch.bfloat16, seed=30)
        lse = heads_nll_reference(p, z, shift, K)[2]
        times["heads_nll_forward"] = (
            cuda_ms(lambda: heads_nll_forward(p, z, shift, K)),
            cuda_ms(lambda: heads_nll_reference(p, z, shift, K)))
        times["heads_nll_backward"] = (
            cuda_ms(lambda: heads_nll_backward(g, lse, p, z, shift, K)),
            cuda_ms(lambda: heads_nll_backward_reference(g, lse, p, z, shift,
                                                         K)))
    for name, (ms, plain) in times.items():
        print(f"time {name} at the slice, bf16, on {card}: kernel {ms:.4f} "
              f"ms, plain {plain:.4f} ms", flush=True)
    return {k: (errs[k], *times[k]) for k in errs}


# ---------------------------------------------------------------- phase 6
TRAIN_STEPS = 10
COUNTED = {"gru_scan": gru_scan, "gru_scan_backward": gru_scan_backward,
           "heads_nll_forward": heads_nll_forward,
           "heads_nll_backward": heads_nll_backward}


def phase6_train() -> dict:
    """Trains tpu_fast through the CLI's main; returns the launch counts."""
    for fn in COUNTED.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        rc = train_cli.main(["--config", "tpu_fast", "--data", "synthetic",
                             "--steps", str(TRAIN_STEPS), "--workdir",
                             workdir])
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
        check(recs[-1]["step"] == TRAIN_STEPS, f"last step {recs[-1]}")
        ckpts = os.listdir(os.path.join(workdir, "checkpoints"))
        check(f"step_{TRAIN_STEPS}.pt" in ckpts, f"checkpoints: {ckpts}")
    print(f"train: {TRAIN_STEPS} steps of tpu_fast through "
          f"cpc_tpu_torch.train.cli.main in {wall:.2f} s (corpus, build "
          f"and warm-up included); last log {json.dumps(recs[-1])}; "
          f"launches {counts}", flush=True)
    for name, n in counts.items():
        check(n == TRAIN_STEPS, f"{name} launched {n} times, expected "
              f"{TRAIN_STEPS} (one per step)")
    return counts


# ---------------------------------------------------------------- phase 7
def plain_loss(model, batch, cfg):
    """The fused tpu_fast loss composed from the model's modules and the
    plain GRU and heads Functions (the package has no switch for this)."""
    K = cfg.model.loss.prediction_steps
    kd = torch.bfloat16 if cfg.model.loss.pallas_bf16 else torch.float32
    z = model.encoder(device_prepare(batch, cfg.data.normalize))
    h = z
    for layer in model.gar.layers():
        hs = _GruScanPlain.apply(*layer.scan_inputs(h, None))  # (T, B, H)
        h = hs.transpose(0, 1)
    W = model.prediction_heads.weight.t().to(kd)
    nll, cor = _HeadsNllPlain.apply(hs.to(kd).contiguous(),
                                    z.to(kd).transpose(0, 1).contiguous(),
                                    W, 0, K)
    return reduce_heads_nll(nll, cor, K, z.shape[0])


# The two steps share the encoder's cuDNN calls exactly; they differ only in
# the GRU's and the heads' fp32 summation order. Loss and grad_norm
# relative, acc absolute (4e-4 is 3 of the 7 424 rows of a k, for argmax
# near-ties), grads relative to their largest entry. Measured on an H100
# 80GB HBM3 at 700 W: loss 2.3e-7, acc 0, grad_norm 2.4e-6, grads 3.8e-6
# (wh) and 1.9e-6 (W); each bound is 4-26x that.
STEP_TOL = {"loss": 1e-6, "acc": 4e-4, "grad_norm": 1e-5, "grad": 1e-4}


def phase7_step(card: str) -> None:
    cfg = presets.tpu_fast()
    model = init_state(cfg, "cuda")
    steps = make_step_fns(cfg, model)
    B, S = cfg.data.batch_size, cfg.data.snippet_samples
    batch = torch.from_numpy(np.clip(np.random.default_rng(3).standard_normal(
        (B, S)) * 3000, -32768, 32767).astype(np.int16)).cuda()
    watched = {"wh": model.gar.layer0.wh,
               "W": model.prediction_heads.weight}
    results = []
    for loss_fn in (steps.loss_fn, lambda m, b: plain_loss(m, b, cfg)):
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        results.append((metrics["loss"].item(), metrics["acc"].float().cpu(),
                        global_norm(p.grad for p in model.parameters()).item(),
                        {k: p.grad.clone() for k, p in watched.items()}))
    (loss, acc, gn, grads), (p_loss, p_acc, p_gn, p_grads) = results
    errs = {"loss": abs(loss - p_loss) / abs(p_loss),
            "acc": (acc - p_acc).abs().max().item(),
            "grad_norm": abs(gn - p_gn) / p_gn}
    for k in watched:
        errs[f"grad {k}"] = rel_err(grads[k], p_grads[k])
    print(f"step vs plain step (tpu_fast, bf16, batch {B}): loss {loss:.6f} "
          f"vs {p_loss:.6f}, grad_norm {gn:.6f} vs {p_gn:.6f}, acc "
          f"{acc.tolist()}; errors {errs} (tolerances {STEP_TOL}: relative "
          f"for loss and grad_norm, absolute for acc, relative to "
          f"max |grad| for grads)", flush=True)
    for k, e in errs.items():
        check(math.isfinite(e) and e <= STEP_TOL[k.split()[0]],
              f"step vs plain: {k} error {e}")

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
    plain_s = timed(plain_step, 3)
    audio = B * S / cfg.data.sample_rate
    print(f"train step (tpu_fast, batch {B} x {S} samples = {audio:.2f} "
          f"audio-s, device-resident batch) on {card}: {step_s * 1e3:.2f} ms "
          f"median of 10 = {audio / step_s:.1f} audio-s/s; the plain step "
          f"(forward and backward only, context) {plain_s * 1e3:.2f} ms",
          flush=True)


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
    # cuDNN's GRU, timed for context only. cuDNN does not flatten bf16 RNN
    # weights, so torch warns; the per-call copy it makes is 0.8 MB
    cudnn = torch.nn.GRU(SLICE_SHAPE[2], SLICE_SHAPE[2]).to("cuda",
                                                           torch.bfloat16)
    max_err = 0.0
    with torch.inference_mode():
        for n, ((T, B, H), dtype) in enumerate(CASES):
            args = gru_inputs(T, B, H, dtype, seed=n)
            out = gru_scan(*args)
            ref = gru_scan_reference(*args)
            torch.cuda.synchronize()
            check(out.dtype == ref.dtype == dtype
                  and tuple(out.shape) == (T, B, H), f"{out.shape} {out.dtype}")
            check(bool(torch.isfinite(out.float()).all()), "non-finite hs")
            err = (out.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            print(f"gru_scan vs plain {(T, B, H)} {str(dtype)[6:]}: max abs "
                  f"err {err:.3e} (tol {TOL[dtype]:.0e})", flush=True)
            check(err <= TOL[dtype], f"gru_scan error {err} > {TOL[dtype]}")

        T, B, H = SLICE_SHAPE
        args = gru_inputs(T, B, H, torch.bfloat16, seed=0)
        ms = cuda_ms(lambda: gru_scan(*args))
        plain_ms = cuda_ms(lambda: gru_scan_reference(*args))
        x = args[0][..., :H].contiguous()
        h0 = args[3][None].to(torch.bfloat16)
        cudnn_ms = cuda_ms(lambda: cudnn(x, h0))
    print(f"time {SLICE_SHAPE} bf16 on {card}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.nn.GRU (cuDNN, context only) "
          f"{cudnn_ms:.4f} ms", flush=True)

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
    measured = phase5_kernels(card)
    counts = phase6_train()
    phase7_step(card)

    measured["gru_scan"] = (max_err, ms, plain_ms)
    sources = {
        "gru_scan": ("gru_scan.cu", "cpc_tpu/ops/gru_pallas.py:57"),
        "gru_scan_backward": ("gru_scan.cu", "cpc_tpu/ops/gru_pallas.py:82"),
        "heads_nll_forward": ("infonce_fused.cu",
                              "cpc_tpu/ops/infonce_fused.py:70"),
        "heads_nll_backward": ("infonce_fused.cu",
                               "cpc_tpu/ops/infonce_fused.py:97")}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"cpc_tpu_torch/csrc/{src}", "replaces": tpu,
        "launches": counts[name], "max_abs_err": measured[name][0],
        "ms": measured[name][1], "plain_ms": measured[name][2]}
        for name, (src, tpu) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
