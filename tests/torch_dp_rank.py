"""One rank of a data-parallel CPU run of the port (gloo); spawned by
tests/test_torch_port_multiprocess.py, not a pytest file.

    python tests/torch_dp_rank.py --rank R --world N --port P --dir D

D holds `cases.json` ({case: the port's config as a dict}), `state.pt`
(the model's weights) and `batches.npy` (the global int16 batches, one a
step). For each case the rank builds the model from the weights, runs the
data-parallel step on its rows of every batch and writes
`<case>.rank<R>.npz`: each step's metrics (`<step>/<name>`), the gradient
the update used (`grad/<name>`, the last step's, averaged over the ranks)
and the parameters after the last step (`param/<name>`).
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
from cpc_tpu_torch.parallel import dp, multihost  # noqa: E402
from cpc_tpu_torch.train.train_step import make_step_fns  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--dir", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    mesh = multihost.initialize(f"127.0.0.1:{args.port}", args.world,
                                args.rank, device="cpu", timeout=120)
    try:
        with open(os.path.join(args.dir, "cases.json")) as f:
            cases = json.load(f)
        state = torch.load(os.path.join(args.dir, "state.pt"))
        batches = np.load(os.path.join(args.dir, "batches.npy"))
        for name, cfg_dict in cases.items():
            cfg = from_dict(cfg_dict)
            model = CPCModel(cfg.model)
            model.load_state_dict(state)
            steps = make_step_fns(cfg, model, mesh)
            out = {}
            for n, batch in enumerate(batches):
                local = multihost.shard_batch(batch, mesh)
                metrics = steps.train_step(torch.from_numpy(local))
                out.update({f"{n}/{k}": v.numpy() for k, v in
                            metrics.items()})
            named = list(model.named_parameters())
            accum = cfg.train.accum_steps
            grads = dp.average([p.grad / accum for _, p in named], mesh)
            out.update({f"grad/{k}": g.numpy()
                        for (k, _), g in zip(named, grads)})
            out.update({f"param/{k}": p.detach().numpy() for k, p in named})
            np.savez(os.path.join(args.dir, f"{name}.rank{args.rank}.npz"),
                     **out)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
