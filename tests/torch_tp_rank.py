"""One rank of a tensor-parallel CPU run of the port (gloo); spawned by
tests/test_torch_port_tp.py, not a pytest file.

    python tests/torch_tp_rank.py --rank R --world N --model M --port P \
        --dir D

D holds `cfg.json` (the port's config as a dict), `state.pt` (the whole
model's weights) and `batch.npy` (the global int16 batch). The rank lays
the world out as a (data, model) mesh with M ranks to a data row, shards
the model, runs one TP step on its rows and writes `rank<R>.pt`: the
step's metrics and the whole parameters after it (`parallel.tp.
gather_params`).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cpc_tpu_torch.config import from_dict  # noqa: E402
from cpc_tpu_torch.models.cpc import CPCModel  # noqa: E402
from cpc_tpu_torch.parallel import multihost, tp  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    for name in ("--rank", "--world", "--model", "--port"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--dir", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    mesh = multihost.initialize(f"127.0.0.1:{args.port}", args.world,
                                args.rank, device="cpu", timeout=120)
    try:
        mesh = multihost.with_model(mesh, args.model, timeout=120)
        with open(os.path.join(args.dir, "cfg.json")) as f:
            cfg = from_dict(json.load(f))
        model = CPCModel(cfg.model)
        model.load_state_dict(torch.load(os.path.join(args.dir, "state.pt")))
        step = tp.make_tp_train_step(cfg, model, mesh)
        batch = np.load(os.path.join(args.dir, "batch.npy"))
        rows = torch.from_numpy(batch[mesh.rows(len(batch))])
        metrics = step.train_step(rows)
        torch.save({"metrics": metrics,
                    "params": tp.gather_params(model, mesh)},
                   os.path.join(args.dir, f"rank{args.rank}.pt"))
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
