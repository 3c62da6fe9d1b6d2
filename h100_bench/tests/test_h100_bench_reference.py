"""The frozen float32 reference against the port's plain path (the CPU
runs the port's plain versions of its kernels) at a tiny size: a
tpu_fast-shaped step, a transformer step and a cross-replica pool step
over two gloo ranks. In float32 both compute the same mathematics, so the
gaps are rounding's; a wrong reference would read gaps of order 1."""

import multiprocessing

import pytest
import torch

from h100_bench import check, harness, reference
from h100_bench.tests.conftest import tiny_cell

TIGHT = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3}


def readings(cell, seed, device="cpu", mesh=None):
    s = harness.Session(cell, seed, device=device, mesh=mesh)
    s.build()
    prog = s.first_steps()
    every = s.gather(prog.pop("inputs"))
    s.free()
    if s.rank != 0:
        return None
    return check.numbers(prog, s.reference(every))


@pytest.mark.parametrize("name", ["tpu_fast.train_b64",
                                  "transformer_fast_flash16.train_t1024"])
def test_reference_follows_the_plain_step(name):
    nums = readings(tiny_cell(name), 2**31 + 7)
    for k, tol in TIGHT.items():
        assert nums[k] <= tol, (k, nums)


def _rank(cell, seed, rank, port, q):
    torch.set_num_threads(1)
    mesh = harness.make_mesh(rank, 2, port, "cpu")
    try:
        q.put((rank, readings(cell, seed, mesh=mesh)))
    finally:
        harness.leave(mesh)


def test_reference_follows_the_cross_replica_step():
    """Two gloo ranks of one row each gather their latents into a pool of
    two; the reference steps on the global batch with the whole pool."""
    cell = tiny_cell("dp_global_negatives.train_4card")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = harness.free_port()
    procs = [ctx.Process(target=_rank, args=(cell, 99, r, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(q.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
        assert p.exitcode == 0
    assert got[1] is None
    for k, tol in TIGHT.items():
        assert got[0][k] <= tol, (k, got[0])


def test_reference_rounds_to_fp8_in_the_control():
    x = torch.linspace(-3, 3, 101)
    y = reference.rounding("fp8")(x)
    assert not torch.equal(x, y)
    # 3 mantissa bits: within half a unit, 2**-4 of the value
    assert ((y - x).abs() <= 0.0625 * x.abs() + 1e-3).all()
    assert torch.equal(reference.rounding("fp32")(x), x)


def test_learning_rate_schedule():
    t = {"learning_rate": 2e-4, "warmup_steps": 1000, "lr_schedule":
         "constant", "num_steps": 10_000}
    assert reference.learning_rate(t, 0) == 0.0
    assert reference.learning_rate(t, 500) == pytest.approx(1e-4)
    assert reference.learning_rate(t, 5000) == 2e-4
    t = dict(t, warmup_steps=0, lr_schedule="cosine")
    assert reference.learning_rate(t, 10_000) == pytest.approx(0.0)
