"""CLI: pack an audio corpus into the pre-decoded memmap format.

    python -m cpc_tpu_torch.data.pack <corpus_dir> <packed_dir> \
        [--rate 16000] [--device cuda]

Port of `cpc_tpu/data/pack.py`; `data.packed` has the layout. Files at
another rate are resampled on `--device` (default cuda, which raises where
there is no GPU). Train on the result with `python -m cpc_tpu_torch.train
--data <packed_dir> --packed`.
"""

from __future__ import annotations

import argparse
import json

import torch

from cpc_tpu_torch.data.packed import pack_corpus


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cpc_tpu_torch.data.pack")
    p.add_argument("corpus_dir")
    p.add_argument("packed_dir")
    p.add_argument("--rate", type=int, default=16_000)
    p.add_argument("--device", default="cuda",
                   help="torch device that resamples (default: cuda)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here")

    meta = pack_corpus(args.corpus_dir, args.packed_dir, args.rate, device)
    print(json.dumps({"files": len(meta["files"]),
                      "total_samples": meta["total_samples"],
                      "hours": round(meta["total_samples"]
                                     / meta["sample_rate"] / 3600, 3),
                      "has_phones": meta["has_phones"],
                      "out": args.packed_dir}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
