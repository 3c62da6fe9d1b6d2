"""The port's ring transport (`cpc_tpu_torch/ops/ring_util.py`) and ring
InfoNCE (`cpc_tpu_torch/ops/infonce_ring.py`), `loss.ring` under a data
mesh, against the JAX package's shard_map runs on the conftest's virtual
CPU devices.

  * the transport: permutations and sums among thread ranks at R = 1-4,
    zeros where a permutation gives nothing, ppermute's gradient back to
    the sender; two gloo processes (`tests/torch_ring_rank.py`) through
    `batch_isend_irecv`, a ring InfoNCE on them equal to one process;
  * `ring_infonce_allsteps` (DP: ranks own batch chunks) at R = 2, 3, 4
    against JAX's `infonce_loss_and_metrics(ring=True)` under shard_map:
    the ranks' mean loss at 1e-6, accuracy at 1e-6, dpreds and dz at 2e-5
    (tests/test_ring_infonce.py's tolerances), and against the port's
    gathered pool;
  * `ring_infonce_allsteps_ctx` (CP: ranks own time chunks) at R = 2, 4, 8,
    on the 2-D (data, ctx) ring at (2, 2) and (4, 2), and with ctx ranks
    that hold no valid row: the loss at 1e-5 / 1e-6, the accuracy EXACTLY
    against JAX's CP run on the same mesh (the pool's order decides a
    tie), both gradients at 2e-5 (tests/test_ring_attention.py:148-168,
    411-471);
  * `loss.ring` under a data mesh: the DP step on thread ranks against
    the gathered all-steps step (loss, accuracy, grad_norm, gradients).

JAX at `jax.default_matmul_precision('highest')`, fp32; one torch thread.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from cpc_tpu.ops.infonce import infonce_loss_and_metrics as j_infonce
from cpc_tpu.ops.infonce_ring import ring_infonce_allsteps_ctx as j_ctx
from cpc_tpu_torch.ops import ring_util
from cpc_tpu_torch.ops.infonce import infonce_loss_and_metrics
from cpc_tpu_torch.ops.infonce_ring import (ring_infonce_allsteps,
                                            ring_infonce_allsteps_ctx)
from cpc_tpu_torch.parallel.mesh import groups_of, thread_meshes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_SCRIPT = os.path.join(REPO, "tests", "torch_ring_rank.py")
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def ranks(world, fn, ctx=1):
    """fn(mesh) on `world` thread ranks, ctx of them to a data row."""
    meshes = thread_meshes(world, "cpu", ctx=ctx, timeout=60)
    return ring_util.run_thread_ranks(
        groups_of(meshes), [functools.partial(fn, m) for m in meshes],
        timeout=120)


def jax_mesh(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


# ----------------------------------------------------------- the transport
@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_thread_transport_permutes_and_sums(R):
    def fn(mesh):
        ring = mesh.ring("data")
        me = ring.index
        x = torch.full((2, 3), float(me))
        shifted = ring.shift(x)
        # every rank sends to rank 0 only: rank 0 receives from the last
        # pair that names it, the others receive nothing (zeros)
        one = ring.permute(x, [(R - 1, 0)])
        total = x.clone() + 0.5
        ring.all_reduce(total)
        return shifted, one, total

    for me, (shifted, one, total) in enumerate(ranks(R, fn)):
        assert torch.equal(shifted, torch.full((2, 3), float((me - 1) % R)))
        want = float(R - 1) if me == 0 else 0.0
        assert torch.equal(one, torch.full((2, 3), want))
        assert torch.equal(total, torch.full((2, 3),
                                             sum(range(R)) + 0.5 * R))


def test_ppermute_gradient_goes_back_to_the_sender():
    def fn(mesh):
        ring = mesh.ring("data")
        x = torch.full((3,), float(ring.index + 1), requires_grad=True)
        y = ring_util.ppermute(x, ring, ring_util.ring_perm(ring.size))
        (y * torch.arange(3.0) * (ring.index + 10)).sum().backward()
        return x.grad

    grads = ranks(3, fn)
    for me, g in enumerate(grads):
        # rank me's x went to rank me+1, which weighs it by me + 11
        assert torch.equal(g, torch.arange(3.0) * ((me + 1) % 3 + 10))


def test_a_permutation_that_receives_twice_raises():
    with pytest.raises(ValueError, match="receives twice"):
        ring_util.Ring(None, [0, 1], 0).permute(torch.zeros(1),
                                                [(0, 0), (1, 0)])


def test_a_failing_rank_releases_the_others():
    def fn(mesh):
        if mesh.rank == 1:
            raise KeyError("boom")
        mesh.ring("data").shift(torch.zeros(1))

    with pytest.raises(RuntimeError, match="rank 1 failed: KeyError"):
        ranks(3, fn)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_through_batch_isend_irecv(tmp_path):
    """Two real processes on gloo: the transport's permutations and sum,
    and the ring InfoNCE over them equal to one process on the whole
    batch (tests/torch_ring_rank.py)."""
    rng = np.random.default_rng(5)
    np.save(tmp_path / "preds.npy",
            rng.standard_normal((4, 9, 2, 8)).astype(np.float32))
    np.save(tmp_path / "z.npy", rng.standard_normal((4, 9, 8)
                                                    ).astype(np.float32))
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, RANK_SCRIPT, "--rank", str(r), "--world", "2",
         "--port", str(port), "--dir", str(tmp_path)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    for r, g in enumerate(got):
        assert g["shifted"] == [float(1 - r)] * 3
        assert g["swapped"] == [float(1 - r) * 10] * 2
        assert g["total"] == [1.0, 3.0]
        assert g["grad_finite"]
    preds = torch.from_numpy(np.load(tmp_path / "preds.npy"))
    z = torch.from_numpy(np.load(tmp_path / "z.npy"))
    loss, m = infonce_loss_and_metrics(preds, z, negatives="all_steps")
    np.testing.assert_allclose(np.mean([g["loss"] for g in got]),
                               loss.item(), rtol=1e-6)
    np.testing.assert_allclose(np.mean([g["acc"] for g in got], axis=0),
                               m["acc"].numpy(), atol=1e-7)


# ------------------------------------------------- the DP ring (batch chunks)
def _dp_data(R, seed, B_loc=2, T=12, K=3, D=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B_loc * R, T, K, D)).astype(np.float32),
            rng.standard_normal((B_loc * R, T, D)).astype(np.float32))


def _jax_dp_ring(preds, z, R):
    """JAX's ring: pmean'ed loss and acc and the grads of the mean loss."""
    mesh = jax_mesh((R,), ("data",))

    def local(p, zz):
        loss, m = j_infonce(p, zz, negatives="all_steps", axis_name="data",
                            ring=True)
        return jax.lax.pmean(loss, "data"), jax.lax.pmean(m["acc"], "data")

    run = jax.jit(jax.shard_map(local, mesh=mesh,
                                in_specs=(P("data"), P("data")),
                                out_specs=(P(), P()), check_vma=False))
    loss, acc = run(preds, z)
    grads = jax.grad(lambda p, zz: run(p, zz)[0], argnums=(0, 1))(preds, z)
    return float(loss), np.asarray(acc), [np.asarray(g) for g in grads]


def _port_dp(preds, z, R, ring=True):
    """The port on R thread ranks: each rank's rows, its loss backward
    scaled by 1 / R (the ranks' mean, as the step averages)."""
    def fn(mesh):
        rows = mesh.rows(len(preds))
        p = torch.from_numpy(preds[rows]).requires_grad_()
        zz = torch.from_numpy(z[rows]).requires_grad_()
        if ring:
            K = p.shape[2]
            loss, m = ring_infonce_allsteps(p[:, :p.shape[1] - K], zz,
                                            mesh=mesh)
        else:
            loss, m = infonce_loss_and_metrics(p, zz, negatives="all_steps",
                                               mesh=mesh)
        (loss / R).backward()
        return loss.item(), m["acc"].numpy(), p.grad.numpy(), zz.grad.numpy()

    out = ranks(R, fn)
    return (np.mean([o[0] for o in out]), np.mean([o[1] for o in out], 0),
            [np.concatenate([o[i] for o in out]) for i in (2, 3)])


@pytest.mark.parametrize("R", [2, 3, 4])
def test_dp_ring_matches_jax(R):
    preds, z = _dp_data(R, seed=R)
    want_loss, want_acc, want_g = _jax_dp_ring(preds, z, R)
    loss, acc, grads = _port_dp(preds, z, R)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    np.testing.assert_allclose(acc, want_acc, atol=1e-6)
    for got, want, name in zip(grads, want_g, ("dpreds", "dz")):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


def test_dp_ring_equals_the_gathered_pool():
    preds, z = _dp_data(4, seed=9)
    ring = _port_dp(preds, z, 4, ring=True)
    gathered = _port_dp(preds, z, 4, ring=False)
    np.testing.assert_allclose(ring[0], gathered[0], rtol=1e-6)
    np.testing.assert_array_equal(ring[1], gathered[1])
    for a, b in zip(ring[2], gathered[2]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_dp_ring_ties_go_to_the_first_global_column():
    # every score ties: the gathered pool's first-index argmax picks
    # column 0, the positive of no row but batch row 0 at t + k + 1 = 0
    # (none): the accuracy is 0 on every rank, in any visiting order
    preds = np.zeros((4, 6, 2, 4), np.float32)
    z = np.ones((4, 6, 4), np.float32)
    loss, acc, _ = _port_dp(preds, z, 2)
    _, want_acc, _ = _jax_dp_ring(preds, z, 2)
    np.testing.assert_array_equal(acc, want_acc)
    np.testing.assert_allclose(loss, np.log(4 * 6), rtol=1e-6)


# ------------------------------------------------ the CP ring (time chunks)
def _ctx_data(B, T, K, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, K, D)).astype(np.float32),
            rng.standard_normal((B, T, D)).astype(np.float32))


def _jax_ctx(preds, z, shape):
    """JAX's time-sharded ring on a (ctx,) or (data, ctx) mesh."""
    two_d = len(shape) == 2
    axes = ("data", "ctx") if two_d else ("ctx",)
    mesh = jax_mesh(shape, axes)
    d = "data" if two_d else None
    run = jax.jit(jax.shard_map(
        functools.partial(j_ctx, axis_name="ctx", data_axis=d), mesh=mesh,
        in_specs=(P(d, "ctx", None, None), P(d, "ctx", None)),
        out_specs=(P(), P())))
    loss, m = run(preds, z)
    grads = jax.grad(lambda p, zz: run(p, zz)[0], argnums=(0, 1))(preds, z)
    return float(loss), np.asarray(m["acc"]), [np.asarray(g) for g in grads]


def _port_ctx(preds, z, shape):
    data, ctx = shape if len(shape) == 2 else (1, shape[0])
    B, T = preds.shape[:2]
    b, t = B // data, T // ctx

    def fn(mesh):
        sl = (slice(mesh.data_rank * b, (mesh.data_rank + 1) * b),
              slice(mesh.ctx_rank * t, (mesh.ctx_rank + 1) * t))
        p = torch.from_numpy(preds[sl]).requires_grad_()
        zz = torch.from_numpy(z[sl]).requires_grad_()
        loss, m = ring_infonce_allsteps_ctx(
            p, zz, mesh=mesh, data_axis="data" if data > 1 else None)
        loss.backward()
        return loss.item(), m["acc"].numpy(), p.grad.numpy(), zz.grad.numpy()

    out = ranks(data * ctx, fn, ctx=ctx)
    for o in out[1:]:
        assert o[0] == out[0][0] and np.array_equal(o[1], out[0][1])

    def whole(i):
        rows = [np.concatenate([out[r * ctx + c][i] for c in range(ctx)], 1)
                for r in range(data)]
        return np.concatenate(rows, 0)
    return out[0][0], out[0][1], [whole(2), whole(3)]


def _held_ctx(preds, z, shape):
    want_loss, want_acc, want_g = _jax_ctx(preds, z, shape)
    loss, acc, grads = _port_ctx(preds, z, shape)
    np.testing.assert_allclose(loss, want_loss, **LOSS_TOL)
    np.testing.assert_array_equal(acc, want_acc)
    for got, want, name in zip(grads, want_g, ("dpreds", "dz")):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)
    # and against the gathered all-steps loss on the whole arrays: the
    # loss and gradients are order-invariant; the accuracy within a tie
    whole, m = infonce_loss_and_metrics(torch.from_numpy(preds),
                                        torch.from_numpy(z),
                                        negatives="all_steps")
    np.testing.assert_allclose(loss, whole.item(), **LOSS_TOL)
    np.testing.assert_allclose(acc, m["acc"].numpy(), atol=1e-6)


@pytest.mark.parametrize("R", [2, 4, 8])
def test_ctx_ring_matches_jax(R):
    _held_ctx(*_ctx_data(3, R * 6, 4, 16, seed=R), (R,))


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_dp_ctx_ring_matches_jax(shape):
    _held_ctx(*_ctx_data(2 * shape[0], shape[1] * 6, 3, 16, seed=11),
              shape)


def test_dp_ctx_ring_with_shards_that_hold_no_valid_row():
    # T_loc = 2 <= K = 3: the last ctx ranks hold only masked rows, and
    # the global denominators still count right
    _held_ctx(*_ctx_data(4, 8, 3, 8, seed=23), (2, 4))


# ---------------------------------------------- loss.ring under a data mesh
def _ring_step_cfg(ring):
    from cpc_tpu_torch import config as tcfg
    return tcfg.CPCConfig(
        name="tiny",
        model=tcfg.ModelConfig(
            encoder=tcfg.EncoderConfig(channels=(16, 16), kernels=(10, 8),
                                       strides=(5, 4), d_enc=16),
            ar=tcfg.ArConfig(d_ar=8),
            loss=tcfg.LossConfig(prediction_steps=2, negatives="all_steps",
                                 ring=ring)),
        data=tcfg.DataConfig(batch_size=4, snippet_samples=800))


def _dp_steps(cfg, batch, world):
    from cpc_tpu_torch.models.cpc import CPCModel
    from cpc_tpu_torch.train.train_step import make_step_fns

    def fn(mesh):
        model = CPCModel(cfg.model,
                         generator=torch.Generator().manual_seed(0))
        steps = make_step_fns(cfg, model, mesh)
        m = steps.train_step(batch[mesh.rows(len(batch))])
        return ({k: v.numpy() for k, v in m.items()},
                {k: p.detach().clone() for k, p in model.named_parameters()})
    return ranks(world, fn)


@pytest.mark.parametrize("world", [2, 4])
def test_loss_ring_under_a_data_mesh_equals_the_gathered_step(world):
    batch = torch.from_numpy(np.clip(np.random.default_rng(3).standard_normal(
        (4, 800)) * 6000, -32768, 32767).astype(np.int16))
    ring = _dp_steps(_ring_step_cfg(True), batch, world)
    gathered = _dp_steps(_ring_step_cfg(False), batch, world)
    for (m_r, p_r), (m_g, p_g) in zip(ring, gathered):
        for k in m_g:
            np.testing.assert_allclose(m_r[k], m_g[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        for k in p_g:
            np.testing.assert_allclose(p_r[k], p_g[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)


def test_ring_negatives_need_the_all_steps_pool():
    mesh = thread_meshes(1, "cpu")[0]
    with pytest.raises(ValueError, match="ring negatives exist for the "
                                         "all_steps pool"):
        infonce_loss_and_metrics(torch.zeros(2, 6, 2, 4),
                                 torch.zeros(2, 6, 4), mesh=mesh, ring=True)
