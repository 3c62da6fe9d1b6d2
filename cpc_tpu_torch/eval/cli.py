"""Feature-extraction CLI of the PyTorch port:

    python -m cpc_tpu_torch.eval --extract AUDIO.wav --workdir DIR \
        [--config NAME] [--hop N] [--out F] [--device cuda]

Port of the `--extract` branch of `cpc_tpu/eval/cli.py`. The config is
`--config`, else `<workdir>/config.json` (written by either package), else
`baseline`. The weights are, in this order: the newest checkpoint that
`python -m cpc_tpu_torch.train` wrote under `<workdir>/<train.checkpoint_dir>`
(as the JAX package's CLI restores its workdir's newest one); else
`<workdir>/jax_params.npz`, the JAX package's params flattened to '/'-joined
keys (`cpc_tpu_torch.interop.flatten_params`); else a model randomly
initialized from `train.seed`, with a warning that says so. The printed JSON
line names the checkpoint's step as `checkpoint_step` (0 without one).
`--device cuda` on a machine without a GPU raises. Probes, the battery and
export wait (ROADMAP.md §A10, §A14).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from cpc_tpu_torch.config import from_dict, presets
from cpc_tpu_torch.data.wavio import decode_mono
from cpc_tpu_torch.eval.features import extract_features
from cpc_tpu_torch.interop import from_jax_params, unflatten_params
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.train.checkpoint import CheckpointManager


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cpc_tpu_torch.eval")
    p.add_argument("--extract", required=True, metavar="AUDIO_FILE",
                   help="run the frozen model over this wav in sliding "
                        "windows and write the (z, c) trajectories")
    p.add_argument("--workdir", required=True)
    p.add_argument("--config", default=None,
                   help="preset name; default: the workdir's config.json, "
                        "falling back to 'baseline'")
    p.add_argument("--hop", type=int, default=None,
                   help="sliding-window hop in samples (< window gives "
                        "overlapped windows with warm gar context; default: "
                        "window)")
    p.add_argument("--out", default=None,
                   help="output .npz (default: <audio>.features.npz)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here")

    saved = os.path.join(args.workdir, "config.json")
    if args.config is not None:
        cfg = presets.by_name(args.config)
    elif os.path.exists(saved):
        with open(saved) as f:
            cfg = from_dict(json.load(f))
    else:
        cfg = presets.by_name("baseline")

    ckpt_dir = os.path.join(args.workdir, cfg.train.checkpoint_dir)
    weights = os.path.join(args.workdir, "jax_params.npz")
    gen = torch.Generator().manual_seed(cfg.train.seed)
    model = CPCModel(cfg.model, generator=gen)
    # the manager creates its directory: only ask it about one that exists
    restored = CheckpointManager(ckpt_dir).restore_latest(
        map_location="cpu") if os.path.isdir(ckpt_dir) else None
    step = 0
    if restored is not None:
        model.load_state_dict(restored["model"])
        step = restored["meta"]["step"]
    elif os.path.exists(weights):
        with np.load(weights) as npz:
            model.load_state_dict(from_jax_params(unflatten_params(npz), cfg))
    else:
        print(json.dumps({"warning": f"no checkpoint under {ckpt_dir} and "
                          f"no {weights}; extracting with a randomly "
                          "initialized model"}))
    model.to(device).eval()

    wave, _ = decode_mono(args.extract, cfg.data.sample_rate)
    z, c = extract_features(model, wave, window=cfg.data.snippet_samples,
                            hop=args.hop, normalize=cfg.data.normalize)
    out = args.out or args.extract + ".features.npz"
    np.savez(out, z=z, c=c)
    print(json.dumps({"checkpoint_step": step, "extract": args.extract,
                      "out": out, "device": str(device),
                      "z_shape": list(z.shape),
                      "c_shape": list(c.shape)}))
    return 0
