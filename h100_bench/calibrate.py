"""Readings that set the limits of a cell's comparison, many seeds in one
process:

    python3 -m h100_bench.calibrate --workload <cell> --seeds 1,2,3
        --mode program|control|half_batch|no_exchange|frozen

One JSON line a seed on standard output: the numbers of `check.numbers`.

- program: the trainer's checked steps, as a run of the cell takes them,
  against the float32 reference (the sound readings: the lower end);
- control: the reference computed with fp8 operands (`reference`'s
  "fp8"), put in the program's place, against the float32 reference, on
  one card whatever the cell's cards (the reference takes the global
  batch);
- frozen, half_batch, no_exchange: the program with that fault planted
  (`faults.py`) under its checked steps.

The benchmark's runs never run this; see PERF.md for the readings and the
limits set from them.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from h100_bench.faults import FAULTS


def parse(argv):
    p = argparse.ArgumentParser(prog="h100_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", required=True,
                   choices=("program", "control", *FAULTS))
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def control_readings(cell, seed: int, device) -> dict:
    """fp8 and fp32 references on the checked steps' shapes: the same
    weights, and rows of a seeded permutation of the corpus."""
    import torch

    from h100_bench import harness, inputs, reference

    cfg, cfg_dict = harness.program_config(cell, seed)
    t = cell.traffic
    weights = inputs.make_weights(reference.param_specs(cfg_dict["model"]),
                                  seed, device)
    corpus = inputs.make_corpus(t["corpus_snippets"], t["snippet_samples"],
                                seed, device)
    order = np.random.default_rng(seed).permutation(t["corpus_snippets"])
    B = t["batch_size"]
    batches = [corpus[torch.from_numpy(order[i * B:(i + 1) * B]).to(device)]
               for i in range(harness.CHECKED_STEPS)]
    exact = reference.train_steps(weights, batches, cfg_dict, "fp32")
    low = reference.train_steps(weights, batches, cfg_dict, "fp8")
    return readings(low, exact)


def readings(prog: dict, ref: dict) -> dict:
    """check.numbers, with the three worst leaves of each norm's gap and
    the median leaf's gap beside them (the look behind a number)."""
    import statistics

    from h100_bench import check

    out = check.numbers(prog, ref)
    for name, keys in (("grad", ref["grad_norm"]), ("change",
                                                    check.moved(ref))):
        gaps = check.leaf_gaps(prog[f"{name}_norm"], ref[f"{name}_norm"],
                               keys)
        out[f"{name}_median_leaf"] = statistics.median(gaps.values())
        out[f"{name}_worst_leaves"] = sorted(gaps, key=lambda k: -gaps[k])[:3]
    return out


def program_readings(s, mode: str) -> dict:
    """The session's checked steps (with `mode`'s fault planted) against
    the reference, on rank 0; None on the others."""
    import contextlib

    from h100_bench import faults

    s.build()
    plant = (contextlib.nullcontext() if mode == "program"
             else faults.planted(mode))
    with plant:
        prog = s.first_steps()
    every = s.gather(prog.pop("inputs"))
    s.free()
    if s.rank != 0:
        return None
    return readings(prog, s.reference(every))


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from h100_bench import harness, spec

    harness.checkout_caches(spec.ROOT)
    cell = spec.load_cell(args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    world = cell.traffic["ranks"] if args.mode != "control" else 1
    procs, port = [], args.port
    if world > 1 and args.rank == 0:
        port = harness.free_port()
        procs = harness.spawn_ranks(
            "h100_bench.calibrate",
            ["--workload", args.workload, "--seeds", args.seeds,
             "--mode", args.mode], world, port)
    try:
        mesh = harness.make_mesh(args.rank, world, port)
        try:
            for seed in seeds:
                if args.mode == "control":
                    nums = control_readings(cell, seed, "cuda")
                else:
                    s = harness.Session(cell, seed, mesh=mesh)
                    nums = program_readings(s, args.mode)
                if nums is not None:
                    print(json.dumps({"workload": cell.name, "mode": args.mode,
                                      "seed": seed, **nums}), flush=True)
        finally:
            harness.leave(mesh)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        codes = harness.reap(procs, timeout=120)
    return 1 if any(codes) else 0


if __name__ == "__main__":
    sys.exit(main())
