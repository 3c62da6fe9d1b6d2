"""A run of each cell, on the CPU at a tiny size past the harness's look
for a card, comes out correct; with the step broken underneath it comes
out not correct, once for each fault the cell can have (faults.py): a
step that leaves its state unchanged, half of the batch left out, and on
the data-parallel cell the exchange between ranks left out. The control,
the reference in fp8, fails the cell's limits too."""

import multiprocessing

import pytest
import torch

from h100_bench import check, faults, harness, inputs, reference
from h100_bench.tests.conftest import tiny_cell

ONE_CARD = ["tpu_fast.train_b64", "transformer_fast_flash16.train_t1024"]
DP = "dp_global_negatives.train_4card"
SEED = 2**31 + 3


def run_one(cell, fault):
    if fault is None:
        return harness.run(cell, SEED, 0.3, False, t_start=0.0, device="cpu")
    with faults.planted(fault):
        return harness.run(cell, SEED, 0.3, False, t_start=0.0, device="cpu")


@pytest.mark.parametrize("name", ONE_CARD)
@pytest.mark.parametrize("fault", [None, "frozen", "half_batch"])
def test_one_card_run(name, fault):
    out = run_one(tiny_cell(name), fault)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_host_feed_run(fault):
    """A traffic whose feed is "host" (the trainer's Batcher thread over
    the corpus in host memory, no device corpus) is checked the same way."""
    cell = tiny_cell("tpu_fast.train_b64")
    cell.traffic = dict(cell.traffic, feed="host")
    out = run_one(cell, fault)
    assert out["correct"] is (fault is None), out["checks"]


def _rank(cell, fault, rank, port, q):
    torch.set_num_threads(1)
    if fault is None:
        out = harness.run(cell, SEED, 0.3, False, t_start=0.0,
                          device="cpu", rank=rank, world=2, port=port)
    else:
        with faults.planted(fault):
            out = harness.run(cell, SEED, 0.3, False, t_start=0.0,
                              device="cpu", rank=rank, world=2, port=port)
    q.put((rank, out))


@pytest.mark.parametrize("fault", [None, "frozen", "half_batch",
                                   "no_exchange"])
def test_data_parallel_run(fault):
    cell = tiny_cell(DP)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = harness.free_port()
    procs = [ctx.Process(target=_rank, args=(cell, fault, r, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(q.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert got[0]["correct"] is (fault is None), got[0]["checks"]


@pytest.mark.parametrize("name", ONE_CARD + [DP])
def test_control_fails_the_limits(name):
    cell = tiny_cell(name, dtype="bfloat16")
    cfg, cfg_dict = harness.program_config(cell, SEED)
    t = cell.traffic
    w = inputs.make_weights(reference.param_specs(cfg_dict["model"]), SEED,
                            "cpu")
    corpus = inputs.make_corpus(t["corpus_snippets"], t["snippet_samples"],
                                SEED, "cpu")
    B = t["batch_size"]
    batches = [corpus[i * B:(i + 1) * B] for i in range(3)]
    exact = reference.train_steps(w, batches, cfg_dict, "fp32")
    low = reference.train_steps(w, batches, cfg_dict, "fp8")
    ok, _ = check.verdict(check.numbers(low, exact), cell.limits)
    assert not ok


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD + [DP])
def test_control_fails_at_the_cells_size(name):
    """On the card: the control at the cell's own size, three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from h100_bench import spec
    from h100_bench.calibrate import control_readings
    cell = spec.load_cell(name)
    for seed in (SEED, SEED + 1, SEED + 2):
        ok, _ = check.verdict(control_readings(cell, seed, "cuda"),
                              cell.limits)
        assert not ok
