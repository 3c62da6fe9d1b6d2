"""Training CLI of the PyTorch port:

    python -m cpc_tpu_torch.train --config tpu_fast --data synthetic \
        --steps N --workdir W [--device cuda]

Port of `cpc_tpu/train/cli.py`, single device. Every preset trains: the
GRU family (`baseline`, `tpu_fast`, ...), the transformer family
(`transformer_gar`, `transformer_fast`), whose attention is chosen with
`--set model.ar.attn_impl=xla|flash|flash16`, and the scalogram family
(`maestro_scalogram`, `scalogram_fast`; its front end with `--set
model.encoder.scalogram_scale=mel|log|cqt`), for music audio best on
`--data synthetic-music`. The config is
`--config`, else (with `--resume`) the workdir's `config.json`, else
`baseline`; the dedicated flags override it, and `--set path=value`
overrides last.
`--data synthetic` (or `synthetic-music`) writes a seeded corpus under the
workdir on first use, as the JAX CLI does; otherwise `--data` is a
directory of WAV and FLAC files (any rate: resampled on `--device` when
decoded), or with `--packed` a corpus packed by `python -m
cpc_tpu_torch.data.pack`. `--device` defaults to cuda and raises where
there is no GPU.

The data feed and the side features, with the JAX CLI's flags:
`--device-corpus` uploads the int16 corpus to the card once and gathers
each batch there; `--augment` augments each batch on the card (gain,
polarity, shift, noise); `--supervise [--stale-after S] [--max-restarts
N]` runs the same command as a child process and restarts it with
`--resume` after a crash or a hang (`train.supervisor`; dispatched before
any CUDA use); `--profile` writes a torch.profiler Chrome trace of the
run under `<workdir>/profile`; `--nan-debug` raises FloatingPointError at
the first non-finite loss or gradient (`utils.profiling`). TensorBoard
scalars go to `<workdir>/tb`.

Data parallelism (`dp_global_negatives`, or any preset): one process a
card, each given the same command and its rank, either

    python -m cpc_tpu_torch.train --config dp_global_negatives \
        --coordinator HOST:PORT --num-processes N --process-id i ...

or `--distributed` under a launcher that sets MASTER_ADDR, MASTER_PORT,
RANK and WORLD_SIZE (torchrun, on each host). Each rank trains on its rows
of the global `--batch-size` on the card of its local rank (its place
among its host's ranks: LOCAL_RANK where the launcher sets it, else found
from the ranks' hostnames); NCCL on cuda, gloo with `--device cpu` (a
rehearsal on CPU processes). The workdir is shared, across hosts too: rank
0 alone writes it (the synthetic corpus, then a barrier; config, metrics,
checkpoints), every rank reads it. `--set train.mesh_axes=data,model`
with a `train.mesh_shape` makes the model axis's ranks replicas that share
their rows, as the JAX trainer does; tensor parallelism proper is
`cpc_tpu_torch.parallel.tp.make_tp_train_step`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os

import torch

from cpc_tpu_torch.config import apply_overrides, from_dict, presets
from cpc_tpu_torch.data.dataset import SnippetDataset
from cpc_tpu_torch.data.packed import PackedSnippetDataset
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.parallel import multihost
from cpc_tpu_torch.train import supervisor
from cpc_tpu_torch.train.trainer import Trainer
from cpc_tpu_torch.utils.profiling import enable_nan_debug, trace


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cpc_tpu_torch.train",
        description="CPC audio pretraining on GPUs (PyTorch port)",
        allow_abbrev=False)
    p.add_argument("--config", default=None,
                   help="preset name (baseline, tpu_fast, ...). Default: "
                        "baseline, or with --resume the workdir's "
                        "config.json")
    p.add_argument("--data", default="synthetic",
                   help="'synthetic', 'synthetic-music', or a corpus "
                        "directory of WAV and FLAC files")
    p.add_argument("--val-data", default=None,
                   help="validation corpus directory (defaults to --data)")
    p.add_argument("--packed", action="store_true",
                   help="--data/--val-data are packed corpora (python -m "
                        "cpc_tpu_torch.data.pack): no decode while training")
    p.add_argument("--workdir", default="runs/default")
    p.add_argument("--steps", type=int, default=None,
                   help="override train.num_steps")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--snippet-samples", type=int, default=None,
                   help="override data.snippet_samples")
    p.add_argument("--augment", action="store_true",
                   help="on-device waveform augmentation (gain, polarity, "
                        "shift, noise) inside the step")
    p.add_argument("--device-corpus", action="store_true",
                   help="upload the whole int16 corpus to the card once and "
                        "feed each step its (B,) index vector (the gather "
                        "runs on the card); the corpus must fit the budget")
    p.add_argument("--lr-schedule", default=None,
                   choices=["constant", "cosine"],
                   help="override train.lr_schedule")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="override train.grad_clip_norm (0 disables)")
    p.add_argument("--accum-steps", type=int, default=None,
                   help="override train.accum_steps (microbatches per "
                        "optimizer step, each its own negative pool)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in the workdir")
    p.add_argument("--supervise", action="store_true",
                   help="run training as a supervised child process: after "
                        "a crash (nonzero exit) or a hang (workdir heartbeat "
                        "stale for --stale-after) the child is terminated "
                        "and relaunched with --resume; the restart budget "
                        "counts consecutive restarts without a new "
                        "checkpoint")
    p.add_argument("--stale-after", type=float,
                   default=supervisor.DEFAULT_STALE_AFTER,
                   help="seconds of workdir silence (no metrics.jsonl or "
                        "checkpoint write) before a supervised child is "
                        "declared hung; must exceed the longest quiet "
                        "period (kernel build, validation)")
    p.add_argument("--max-restarts", type=int,
                   default=supervisor.DEFAULT_MAX_RESTARTS,
                   help="consecutive no-progress restarts before the "
                        "supervisor gives up")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--profile", action="store_true",
                   help="record the run with torch.profiler; a Chrome trace "
                        "goes to <workdir>/profile")
    p.add_argument("--nan-debug", action="store_true",
                   help="autograd anomaly mode; the first non-finite loss "
                        "or gradient raises FloatingPointError naming the "
                        "step")
    p.add_argument("--set", action="append", default=[], metavar="PATH=VAL",
                   dest="overrides",
                   help="override any config field by dotted path, e.g. "
                        "--set train.learning_rate=3e-4; applied last; "
                        "repeatable")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda; under "
                        "data parallelism each rank takes cuda:<its local "
                        "rank>, its place among its host's ranks)")
    p.add_argument("--distributed", action="store_true",
                   help="one process of a data-parallel run, its rank and "
                        "world from the launcher's environment (MASTER_ADDR, "
                        "MASTER_PORT, RANK, WORLD_SIZE, and LOCAL_RANK, "
                        "LOCAL_WORLD_SIZE where torchrun sets them); launch "
                        "the same command once a card, on every host. The "
                        "workdir must be shared")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address for the rendezvous (implies "
                        "--distributed); requires --num-processes and "
                        "--process-id. At 127.0.0.1 every rank is on this "
                        "host; at a host's address ranks may be on several, "
                        "each placed by its local rank among its host's")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def check_distributed_args(args) -> None:
    """The data-parallel flags' checks, as the JAX CLI makes them."""
    if args.coordinator is not None and (args.num_processes is None
                                         or args.process_id is None):
        raise SystemExit("--coordinator requires --num-processes and "
                         "--process-id")
    if not (args.distributed or args.coordinator is not None) and (
            args.num_processes is not None or args.process_id is not None):
        raise SystemExit("--num-processes and --process-id need "
                         "--coordinator or --distributed")


def resolve_config(args):
    saved = os.path.join(args.workdir, "config.json")
    if args.config is not None:
        cfg = presets.by_name(args.config)
    elif args.resume and os.path.exists(saved):
        with open(saved) as f:
            cfg = from_dict(json.load(f))
    else:
        cfg = presets.by_name("baseline")
    train = {k: v for k, v in (("num_steps", args.steps), ("seed", args.seed),
                               ("lr_schedule", args.lr_schedule),
                               ("grad_clip_norm", args.grad_clip),
                               ("accum_steps", args.accum_steps))
             if v is not None}
    data = {k: v for k, v in (("batch_size", args.batch_size),
                              ("snippet_samples", args.snippet_samples),
                              ("augment", args.augment or None),
                              ("device_corpus", args.device_corpus or None))
            if v is not None}
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **train),
        data=dataclasses.replace(cfg.data, **data))
    return apply_overrides(cfg, args.overrides) if args.overrides else cfg


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    check_distributed_args(args)
    if args.supervise:
        # the same command, without the supervisor's flags, as a child
        return supervisor.supervise_cli(args, argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here")
    cfg = resolve_config(args)
    mesh = None
    if args.distributed or args.coordinator is not None:
        mesh = multihost.initialize(args.coordinator, args.num_processes,
                                    args.process_id, device=device)
        device = mesh.device
    try:
        return _train(args, cfg, device, mesh)
    finally:
        if mesh is not None:
            multihost.shutdown()


def _train(args, cfg, device, mesh) -> int:
    main_rank = multihost.is_main(mesh)
    if args.data in ("synthetic", "synthetic-music"):
        corpus = os.path.join(args.workdir, "synthetic_corpus")
        # rank 0 alone writes the shared workdir; the others wait for it
        if main_rank and not os.path.isdir(corpus):
            generate_synthetic_corpus(
                corpus, style="music" if args.data.endswith("music")
                else "speech",
                num_speakers=max(8, cfg.data.batch_size),
                files_per_speaker=3, seconds_per_file=4.0,
                seed=cfg.train.seed)
        multihost.barrier(mesh)
    else:
        corpus = args.data
    val_corpus = args.val_data or corpus
    d = cfg.data
    if args.packed:
        train_ds = PackedSnippetDataset(corpus, d.snippet_samples,
                                        d.snippet_stride, d.sample_rate)
        val_ds = PackedSnippetDataset(val_corpus, d.snippet_samples,
                                      d.snippet_samples, d.sample_rate)
    else:
        train_ds = SnippetDataset(corpus, d.snippet_samples, d.snippet_stride,
                                  d.sample_rate, device=device)
        val_ds = SnippetDataset(val_corpus, d.snippet_samples,
                                d.snippet_samples, d.sample_rate,
                                device=device)

    trainer = Trainer(cfg, train_ds, val_ds, workdir=args.workdir,
                      device=device, mesh=mesh)
    try:
        if args.resume:
            resumed = trainer.maybe_resume()
            if main_rank:
                print("resume: " + (f"restored step {trainer.step}"
                                    if resumed else "no checkpoint found"))
        if main_rank:
            print(f"config={cfg.name} device={device} "
                  f"processes={1 if mesh is None else mesh.size} "
                  f"batch={cfg.data.batch_size} steps={cfg.train.num_steps}")
        if args.nan_debug:
            enable_nan_debug()
        with (trace(os.path.join(args.workdir, "profile")) if args.profile
              else contextlib.nullcontext()):
            trainer.train()
    finally:
        if args.nan_debug:
            enable_nan_debug(False)
        trainer.close()
    return 0
