"""Probe and feature-extraction CLI of the PyTorch port:

    python -m cpc_tpu_torch.eval --workdir DIR [--battery | --probe both]
    python -m cpc_tpu_torch.eval --extract AUDIO.wav --workdir DIR \
        [--config NAME] [--hop N] [--out F] [--device cuda]

Port of `cpc_tpu/eval/cli.py`. The config is `--config`, else
`<workdir>/config.json` (written by either package), else `baseline`. The
weights come from `load_weights`. The printed JSON line names the
checkpoint's step as `checkpoint_step` (0 without one).

Without `--extract` the CLI probes the frozen model: `--probe
speaker|phone|both` prints the probes' results, `--battery` the full
battery's row (`eval.battery.probe_milestone`). `--data synthetic` (the
default) probes the corpus under `<workdir>/synthetic_corpus`, written
there on first use as the JAX CLI writes it; `--packed` reads `--data` as
a packed corpus (`data.packed`). `--device cuda` (the default) on a
machine without a GPU raises; files at another rate than the config's are
resampled on it. The `--export-*` flags wait for ROADMAP.md A9: each is
accepted and raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from cpc_tpu_torch.config import CPCConfig, from_dict, presets
from cpc_tpu_torch.data.dataset import ProbeDataset
from cpc_tpu_torch.data.packed import PackedSnippetDataset
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.data.wavio import decode_mono
from cpc_tpu_torch.eval.battery import probe_milestone
from cpc_tpu_torch.eval.features import extract_features
from cpc_tpu_torch.eval.probes import run_phone_probe, run_speaker_probe
from cpc_tpu_torch.interop import from_jax_params, unflatten_params
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.train.checkpoint import CheckpointManager

_EXPORT_FLAGS = ("export_model", "export_batch", "export_streaming",
                 "export_dtype", "export_stats")


def load_weights(model: CPCModel, workdir: str,
                 cfg: CPCConfig) -> Optional[int]:
    """Loads a workdir's weights into `model`, in this order: the newest
    checkpoint that `python -m cpc_tpu_torch.train` wrote under
    `<workdir>/<train.checkpoint_dir>`; else `<workdir>/jax_params.npz`,
    the JAX package's params flattened to '/'-joined keys
    (`cpc_tpu_torch.interop.flatten_params`). Returns the checkpoint's step
    (0 for jax_params.npz), or None when the workdir holds neither."""
    ckpt_dir = os.path.join(workdir, cfg.train.checkpoint_dir)
    # the manager creates its directory: only ask it about one that exists
    restored = CheckpointManager(ckpt_dir).restore_latest(
        map_location="cpu") if os.path.isdir(ckpt_dir) else None
    if restored is not None:
        model.load_state_dict(restored["model"])
        return restored["meta"]["step"]
    weights = os.path.join(workdir, "jax_params.npz")
    if os.path.exists(weights):
        with np.load(weights) as npz:
            model.load_state_dict(from_jax_params(unflatten_params(npz), cfg))
        return 0
    return None


def cuda_or_raise(name: str) -> torch.device:
    """torch.device(name); raises for a CUDA device where there is none."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device here")
    return device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cpc_tpu_torch.eval")
    p.add_argument("--workdir", required=True)
    p.add_argument("--config", default=None,
                   help="preset name; default: the workdir's config.json, "
                        "falling back to 'baseline'")
    p.add_argument("--data", default="synthetic",
                   help="probe corpus directory, or 'synthetic' (written "
                        "under the workdir on first use)")
    p.add_argument("--probe", default="both",
                   choices=["speaker", "phone", "both"])
    p.add_argument("--packed", action="store_true",
                   help="--data is a packed corpus (python -m "
                        "cpc_tpu_torch.data.pack)")
    p.add_argument("--feature", default="c", choices=["c", "z"])
    p.add_argument("--split", default="snippet", choices=["snippet", "file"],
                   help="probe train/eval split (speaker AND phone). 'file' "
                        "holds out whole utterances — the honest protocol")
    p.add_argument("--battery", action="store_true",
                   help="run the FULL probe battery instead of single "
                        "probes (eval/battery.py); prints one JSON row")
    p.add_argument("--probe-seeds", type=int, default=3,
                   help="split seeds per battery column (mean ± std)")
    p.add_argument("--time-pool", default="mean",
                   choices=["mean", "last", "max"],
                   help="speaker-probe readout over the snippet's frames")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--max-snippets", type=int, default=512)
    p.add_argument("--extract", default=None, metavar="AUDIO_FILE",
                   help="instead of probing: run the frozen model over this "
                        "wav in sliding windows and write the (z, c) "
                        "trajectories")
    p.add_argument("--out", default=None,
                   help="output .npz for --extract (default: "
                        "<audio>.features.npz)")
    p.add_argument("--hop", type=int, default=None,
                   help="--extract sliding-window hop in samples (< window "
                        "gives overlapped windows with warm gar context; "
                        "default: window)")
    for flag in ("--export-model", "--export-batch", "--export-streaming",
                 "--export-dtype"):
        p.add_argument(flag, default=None,
                       help="serving-artifact export (not ported yet: "
                            "ROADMAP.md A9)")
    p.add_argument("--export-streams", type=int, default=1,
                   help="serving-artifact export (not ported yet: "
                        "ROADMAP.md A9)")
    p.add_argument("--export-stats", type=float, nargs=2, default=None,
                   metavar=("MEAN", "STD"),
                   help="serving-artifact export (not ported yet: "
                        "ROADMAP.md A9)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)

    if args.export_streams != 1 or any(getattr(args, f) is not None
                                       for f in _EXPORT_FLAGS):
        raise NotImplementedError(
            "the --export-* flags (the StableHLO serving artifact) are not "
            "ported yet: ROADMAP.md A9")
    device = cuda_or_raise(args.device)

    saved = os.path.join(args.workdir, "config.json")
    if args.config is not None:
        cfg = presets.by_name(args.config)
    elif os.path.exists(saved):
        with open(saved) as f:
            cfg = from_dict(json.load(f))
    else:
        cfg = presets.by_name("baseline")

    model = CPCModel(cfg.model,
                     generator=torch.Generator().manual_seed(cfg.train.seed))
    step = load_weights(model, args.workdir, cfg)
    if step is None:
        ckpt_dir = os.path.join(args.workdir, cfg.train.checkpoint_dir)
        weights = os.path.join(args.workdir, "jax_params.npz")
        print(json.dumps({"warning": f"no checkpoint under {ckpt_dir} and "
                          f"no {weights}; using a randomly initialized "
                          "model"}))
        step = 0
    model.to(device).eval()

    if args.extract:
        wave, _ = decode_mono(args.extract, cfg.data.sample_rate, device)
        z, c = extract_features(model, wave, window=cfg.data.snippet_samples,
                                hop=args.hop, normalize=cfg.data.normalize)
        out = args.out or args.extract + ".features.npz"
        np.savez(out, z=z, c=c)
        print(json.dumps({"checkpoint_step": step, "extract": args.extract,
                          "out": out, "device": str(device),
                          "z_shape": list(z.shape),
                          "c_shape": list(c.shape)}))
        return 0

    if args.data == "synthetic":
        corpus = os.path.join(args.workdir, "synthetic_corpus")
        if not os.path.isdir(corpus):
            generate_synthetic_corpus(corpus, num_speakers=8,
                                      files_per_speaker=3,
                                      seconds_per_file=4.0, seed=0)
    else:
        corpus = args.data
    d = cfg.data
    if args.packed:
        ds = PackedSnippetDataset(corpus, d.snippet_samples,
                                  d.snippet_samples, d.sample_rate)
    else:
        ds = ProbeDataset(corpus, d.snippet_samples, d.snippet_samples,
                          d.sample_rate, device=device)

    if args.battery:
        row = {"checkpoint_step": step,
               **probe_milestone(model, ds, normalize=cfg.data.normalize,
                                 probe_seeds=args.probe_seeds)}
        print(json.dumps(row))
        return 0

    results = {"checkpoint_step": step, "feature": args.feature}
    if args.probe in ("speaker", "both"):
        r = run_speaker_probe(model, ds, feature=args.feature,
                              steps=args.steps,
                              max_snippets=args.max_snippets,
                              normalize=cfg.data.normalize,
                              split=args.split, time_pool=args.time_pool)
        results["speaker_probe"] = dataclasses.asdict(r)
    if args.probe in ("phone", "both"):
        r = run_phone_probe(model, ds, feature=args.feature,
                            steps=args.steps,
                            max_snippets=args.max_snippets,
                            normalize=cfg.data.normalize,
                            split=args.split)
        results["phone_probe"] = dataclasses.asdict(r)
    print(json.dumps(results))
    return 0
