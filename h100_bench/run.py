"""The benchmark of the PyTorch port on NVIDIA cards: one run of one cell.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds `cpc_tpu_torch/`. The cell is an
entry of BENCHMARK.json's `workloads`; its files are found by name
(`h100_bench/spec.py`). The last line of standard output is the result, a
JSON object: `correct`, `attempted` (steps trained in the window),
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with a trace `breakdown`, and last `checks`,
each compared number with its limit (also the last lines of standard
error). A cell on N cards runs N processes, one a card: this one is rank 0
and starts the others.

Exits non-zero, with no result, without CUDA or with fewer cards than the
cell asks for, and when the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="h100_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    import torch

    from h100_bench import harness, spec

    harness.checkout_caches(spec.ROOT)
    cell = spec.load_cell(args.workload)
    world = cell.traffic["ranks"]
    if world != cell.chips:
        raise SystemExit(f"{cell.name}: the traffic runs {world} ranks, "
                         f"the cell asks for {cell.chips} chips")
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < world:
        print(f"h100_bench: {cell.name} needs {world} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    procs, port = [], args.port
    if world > 1 and args.rank == 0:
        from cpc_tpu_torch.ops import _build
        _build.load_library()  # one build, before the ranks start
        port = harness.free_port()
        procs = harness.spawn_ranks(
            "h100_bench.run",
            ["--workload", args.workload, "--seed", str(args.seed),
             "--seconds", str(args.seconds), "--trace", str(args.trace)],
            world, port)
    try:
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START, rank=args.rank, world=world,
                          port=port)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        codes = harness.reap(procs, timeout=120)
    if any(codes):
        print(f"h100_bench: ranks exited {codes}", file=sys.stderr)
        return 1
    if out is not None:
        found = harness.forbidden_modules()
        if found:
            print(f"h100_bench: the process loaded {found}", file=sys.stderr)
            return 1
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
