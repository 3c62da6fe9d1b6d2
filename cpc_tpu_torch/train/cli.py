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
workdir on first use, as the JAX CLI does. `--device` defaults to cuda and
raises where there is no GPU.

Data parallelism (`dp_global_negatives`, or any preset): one process a
card, each given the same command and its rank, either

    python -m cpc_tpu_torch.train --config dp_global_negatives \
        --coordinator HOST:PORT --num-processes N --process-id i ...

or `--distributed` under a launcher that sets MASTER_ADDR, MASTER_PORT,
RANK and WORLD_SIZE (torchrun). Each rank trains on its rows of the global
`--batch-size`; NCCL on cuda, gloo with `--device cpu` (a rehearsal on CPU
processes). The workdir is shared: rank 0 alone writes it (the synthetic
corpus, then a barrier; config, metrics, checkpoints), every rank reads it.
Not offered yet (ROADMAP.md A7, A8): --packed, --augment, --device-corpus,
--supervise, --profile and --nan-debug.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from cpc_tpu_torch.config import apply_overrides, from_dict, presets
from cpc_tpu_torch.data.dataset import SnippetDataset
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.parallel import multihost
from cpc_tpu_torch.train.trainer import Trainer


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
                        "directory of WAV files")
    p.add_argument("--val-data", default=None,
                   help="validation corpus directory (defaults to --data)")
    p.add_argument("--workdir", default="runs/default")
    p.add_argument("--steps", type=int, default=None,
                   help="override train.num_steps")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--snippet-samples", type=int, default=None,
                   help="override data.snippet_samples")
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
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--set", action="append", default=[], metavar="PATH=VAL",
                   dest="overrides",
                   help="override any config field by dotted path, e.g. "
                        "--set train.learning_rate=3e-4; applied last; "
                        "repeatable")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda; under "
                        "data parallelism each rank takes cuda:<its rank>)")
    p.add_argument("--distributed", action="store_true",
                   help="one process of a data-parallel run, its rank and "
                        "world from the launcher's environment (MASTER_ADDR, "
                        "MASTER_PORT, RANK, WORLD_SIZE); launch the same "
                        "command once a card. The workdir must be shared")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address for the rendezvous (implies "
                        "--distributed); requires --num-processes and "
                        "--process-id")
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
                              ("snippet_samples", args.snippet_samples))
            if v is not None}
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **train),
        data=dataclasses.replace(cfg.data, **data))
    return apply_overrides(cfg, args.overrides) if args.overrides else cfg


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    check_distributed_args(args)
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
    train_ds = SnippetDataset(corpus, d.snippet_samples, d.snippet_stride,
                              d.sample_rate)
    val_ds = SnippetDataset(val_corpus, d.snippet_samples, d.snippet_samples,
                            d.sample_rate)

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
        trainer.train()
    finally:
        trainer.close()
    return 0
