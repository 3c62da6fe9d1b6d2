"""One rank of a two-process gloo run of the port's ring transport; spawned
by tests/test_torch_port_ring_infonce.py, not a pytest file.

    python tests/torch_ring_rank.py --rank R --world 2 --port P --dir D

D holds `preds.npy` (B, T, K, D) and `z.npy` (B, T, D), the global batch.
The rank shifts a tensor round the ring, swaps another by an explicit
permutation, sums a third over the ranks, runs `ring_infonce_allsteps` on
its rows of the batch with a backward, and writes `rank<R>.json`.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cpc_tpu_torch.ops.infonce_ring import ring_infonce_allsteps  # noqa: E402
from cpc_tpu_torch.parallel import multihost  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--dir", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    mesh = multihost.initialize(f"127.0.0.1:{args.port}", args.world,
                                args.rank, device="cpu", timeout=60)
    try:
        ring = mesh.ring("data")
        me = float(ring.index)
        shifted = ring.shift(torch.full((3,), me))
        swapped = ring.permute(torch.full((2,), me * 10), [(0, 1), (1, 0)])
        total = torch.tensor([1.0, 2.0]) if me == 0 else torch.tensor(
            [0.0, 1.0])
        ring.all_reduce(total)
        preds = np.load(os.path.join(args.dir, "preds.npy"))
        z = np.load(os.path.join(args.dir, "z.npy"))
        rows = mesh.rows(len(preds))
        K = preds.shape[2]
        pt = torch.from_numpy(preds[rows][:, :preds.shape[1] - K])
        pt.requires_grad_()
        loss, m = ring_infonce_allsteps(pt, torch.from_numpy(z[rows]),
                                        mesh=mesh)
        loss.backward()
        out = {"shifted": shifted.tolist(), "swapped": swapped.tolist(),
               "total": total.tolist(), "loss": loss.item(),
               "acc": m["acc"].tolist(),
               "grad_finite": bool(torch.isfinite(pt.grad).all())}
        with open(os.path.join(args.dir, f"rank{args.rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
