"""The sizes of a cell that the counting functions read, from the
configuration file and the traffic file alone.

`dims` derives what every part shares (one rank's rows B, the snippet S,
the latent steps T, the candidate pool C, K, the widths D and A, the ranks
and the compute dtype's bytes) and passes the configuration's `model`
section and the traffic through whole, so that a counting module reads any
other setting it needs (an encoder's strides, a gar's layers, the loss's
negatives) itself. T comes from the counting module of the cell's encoder:
the one whose `latents(model, samples)` gives a number.
"""

from __future__ import annotations

from h100_bench import spec

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def latents(model: dict, samples: int, parts=None) -> int:
    """The encoder's output steps for `samples` samples."""
    parts = spec.count_modules() if parts is None else parts
    for p in parts.values():
        t = getattr(p, "latents", lambda m, s: None)(model, samples)
        if t is not None:
            return t
    raise KeyError(f"no counts/ module gives the latents of encoder "
                   f"{model['encoder']['kind']!r}")


def dims(config: dict, traffic: dict, parts=None) -> dict:
    model = config["config"]["model"]
    loss = model["loss"]
    world = traffic["ranks"]
    rows = traffic["batch_size"] // world
    pool = rows * world if loss["cross_replica"] and world > 1 else rows
    return {
        "world": world, "B": rows, "S": traffic["snippet_samples"],
        "T": latents(model, traffic["snippet_samples"], parts), "C": pool,
        "K": loss["prediction_steps"], "D": model["encoder"]["d_enc"],
        "A": model["ar"]["d_ar"], "itemsize": ITEMSIZE[model["dtype"]],
        "model": model, "traffic": traffic,
    }
