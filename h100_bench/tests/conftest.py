"""Shared helpers of the benchmark's tests: tiny copies of the cells that a
CPU test run can hold, and one torch thread a test process."""

import copy

import pytest
import torch

from h100_bench import spec


@pytest.fixture(autouse=True)
def one_thread():
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def tiny_cell(name: str, dtype: str = "float32") -> spec.Cell:
    """The cell `name` with its widths cut to 16, K = 3, 2 rows a rank of
    2 560 samples (T = 16), the cell's own limits and feed."""
    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    model = cell.config["config"]["model"]
    model["encoder"].update(channels=[16] * 5, d_enc=16)
    model["ar"].update(d_ar=16, num_heads=2)
    model["loss"]["prediction_steps"] = 3
    model["dtype"] = dtype
    model["loss"]["pallas_bf16"] = dtype != "float32"
    if dtype == "float32" and model["ar"]["attn_impl"] == "flash16":
        model["ar"]["attn_impl"] = "flash"  # flash16 rounds P to bf16
    ranks = cell.traffic["ranks"]
    ranks = 2 if ranks > 1 else 1
    cell.traffic = dict(cell.traffic, ranks=ranks, batch_size=2 * ranks,
                        snippet_samples=2560, corpus_snippets=24,
                        trace_steps=2)
    return cell
