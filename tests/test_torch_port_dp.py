"""The port's data parallelism in one process (`cpc_tpu_torch.parallel`):

  * `gather_pool` against single-process autograd on the concatenated
    batch, for the three InfoNCE paths, with the ranks played by threads
    whose all_reduce sums their buffers in rank order: the loss, accuracy
    and gradients of the ranks' mean losses within fp32 rounding (1e-6);
    the gathered rows, and the pool's gradient summed in fp32 and rounded
    once to z's dtype, bit for bit in fp32 and bf16; `average`;
  * a data-parallel step on a one-rank gloo group bit-equal to the step
    without a mesh (loss, per-k accuracy, grad_norm, every gradient and
    parameter), on each loss path and with accumulation; the trainer and
    the CLI under a one-rank mesh bit-equal to their runs without one;
  * `dropout_generator`: rank 0 draws what it drew before ranks existed,
    other ranks draw otherwise;
  * the checks: a mesh shape that is not the world, a batch the world does
    not divide, the CLI's flags, two NCCL ranks on one card; context
    parallelism, 'model' axes under 'dp' and `loss.ring` run on a mesh, and
    a launcher's layout across hosts is taken.

Everything runs on the CPU with one torch thread.
"""

import dataclasses
import functools
import json
import socket
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.data.dataset import SnippetDataset
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.ops.infonce import infonce_loss_and_metrics
from cpc_tpu_torch.ops.infonce_fused import fused_heads_infonce
from cpc_tpu_torch.parallel import dp, multihost
from cpc_tpu_torch.parallel.mesh import (ProcessMesh, check_one_rank_a_device,
                                         mesh_size, rank_device)
from cpc_tpu_torch.train import cli
from cpc_tpu_torch.train.train_step import dropout_generator, make_step_fns
from cpc_tpu_torch.train.trainer import Trainer

B, T, K, D, A, SAMPLES = 4, 12, 3, 8, 6, 800


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_rank():
    """This process as a world of one on gloo, for one test."""
    mesh = multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                device="cpu", timeout=60)
    try:
        yield mesh
    finally:
        multihost.shutdown()


# ------------------------------------------------------ two ranks, threads
class _Threads:
    """All_reduce (sum) among threads that play the ranks: each rank's
    buffer is summed in rank order."""

    def __init__(self, world):
        self.world = world
        self.bufs = [None] * world
        self.barrier = threading.Barrier(world, timeout=30)

    def all_reduce(self, t, op=None, group=None):
        self.bufs[group] = t.clone()
        self.barrier.wait()
        total = self.bufs[0].clone()
        for b in self.bufs[1:]:
            total += b
        self.barrier.wait()
        t.copy_(total)


def _as_ranks(world, fn, monkeypatch):
    """fn(mesh) in `world` threads, one a rank; returns their results."""
    threads = _Threads(world)
    monkeypatch.setattr(dist, "all_reduce", threads.all_reduce)
    out, errors = [None] * world, []

    def run(r):
        try:
            out[r] = fn(ProcessMesh(rank=r, size=world,
                                    device=torch.device("cpu"), group=r))
        except BaseException as e:  # reported below, with the rank
            errors.append((r, e))
            threads.barrier.abort()
    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    return out


def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"c": torch.from_numpy(rng.standard_normal((B, T, A))).float(),
            "z": torch.from_numpy(rng.standard_normal((B, T, D))).float(),
            "W": torch.from_numpy(rng.standard_normal((A, K * D))
                                  / np.sqrt(A)).float()}


def _loss(path, t, **kw):
    """The loss of `path` on the inputs `t` (c, z, W)."""
    if path == "fused":
        return fused_heads_infonce(t["c"], t["z"], t["W"], num_steps=K,
                                   **kw)
    preds = (t["c"] @ t["W"]).reshape(*t["c"].shape[:2], K, D)
    negatives = "all_steps" if path == "all_steps" else "same_step"
    return infonce_loss_and_metrics(preds, t["z"], negatives=negatives,
                                    use_pallas=path != "plain", **kw)


@pytest.mark.parametrize("path", ["fused", "same_step", "plain",
                                  "all_steps"])
def test_gather_pool_matches_the_concatenated_batch(path, monkeypatch):
    full = {k: v.requires_grad_() for k, v in _loss_inputs().items()}
    loss, metrics = _loss(path, full)
    loss.backward()
    world, b = 2, B // 2

    def rank(mesh):
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
        t = {k: (v.detach()[rows] if k != "W" else v.detach()).clone()
             .requires_grad_() for k, v in full.items()}
        loss, metrics = _loss(path, t, mesh=mesh)
        loss.backward()
        return loss.detach(), metrics["acc"], {k: v.grad for k, v in t.items()}

    ranks = _as_ranks(world, rank, monkeypatch)
    # each rank's loss is its rows' mean against the whole pool
    np.testing.assert_allclose(sum(r[0] for r in ranks) / world, loss.item(),
                               rtol=1e-6)
    np.testing.assert_allclose(sum(r[1] for r in ranks) / world,
                               metrics["acc"], rtol=0, atol=1e-7)
    for r, (_, _, grads) in enumerate(ranks):
        rows = slice(r * b, (r + 1) * b)
        for k in ("c", "z"):  # d(sum of the ranks' losses) = world x d(loss)
            np.testing.assert_allclose(grads[k] / world, full[k].grad[rows],
                                       rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(sum(r[2]["W"] for r in ranks) / world,
                               full["W"].grad, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_pool_rows_and_reduced_gradient(dtype, monkeypatch):
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((6, 5))).to(dtype)
    g = torch.from_numpy(rng.standard_normal((3, 6, 5))).to(dtype)

    def rank(mesh):
        zr = z[2 * mesh.rank:2 * mesh.rank + 2].clone().requires_grad_()
        pool, shift = dp.gather_pool(zr, mesh)
        pool.backward(g[mesh.rank])
        return pool.detach(), shift, zr.grad

    ranks = _as_ranks(3, rank, monkeypatch)
    for r, (pool, shift, grad) in enumerate(ranks):
        assert torch.equal(pool, z) and shift == 2 * r
        assert grad.dtype == dtype
        # the ranks' gradients of the pool summed in fp32, rounded once
        want = g.float().sum(0)[2 * r:2 * r + 2].to(dtype)
        assert torch.equal(grad, want)


def test_average_is_the_mean_in_each_dtype(monkeypatch):
    vals = [[torch.tensor([1.0, 2.0]), torch.tensor(3.0, dtype=torch.bfloat16)],
            [torch.tensor([3.0, 6.0]), torch.tensor(5.0, dtype=torch.bfloat16)]]
    ranks = _as_ranks(2, lambda mesh: dp.average(vals[mesh.rank], mesh),
                      monkeypatch)
    for got in ranks:
        assert torch.equal(got[0], torch.tensor([2.0, 4.0]))
        assert torch.equal(got[1], torch.tensor(4.0, dtype=torch.bfloat16))


# ---------------------------------------------------- a world of one rank
def _cfg(**loss):
    return tcfg.CPCConfig(
        name="tiny",
        model=tcfg.ModelConfig(
            encoder=tcfg.EncoderConfig(channels=(16, 16), kernels=(10, 8),
                                       strides=(5, 4), d_enc=16),
            ar=tcfg.ArConfig(d_ar=8),
            loss=tcfg.LossConfig(**{"prediction_steps": 2, "use_pallas": True,
                                    **loss})),
        data=tcfg.DataConfig(batch_size=B, snippet_samples=SAMPLES))


def _batches(n=2, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(np.clip(rng.standard_normal((B, SAMPLES)) * 6000,
                                     -32768, 32767).astype(np.int16))
            for _ in range(n)]


PATHS = {"fused": dict(fuse_heads=True), "same_step": {},
         "all_steps": dict(negatives="all_steps"),
         "plain": dict(use_pallas=False)}


@pytest.mark.parametrize("path,accum", [(p, 1) for p in PATHS]
                         + [("fused", 2)])
def test_one_rank_dp_step_is_bit_equal_to_the_step(path, accum, one_rank):
    cfg = _cfg(**PATHS[path])
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, accum_steps=accum))
    models = [CPCModel(cfg.model, generator=torch.Generator().manual_seed(0))
              for _ in range(2)]
    steps = [make_step_fns(cfg, models[0]),
             make_step_fns(cfg, models[1], one_rank)]
    for batch in _batches():
        m0, m1 = (s.train_step(batch) for s in steps)
        assert m0.keys() == m1.keys()
        for k in m0:
            assert torch.equal(m0[k], m1[k]), k
        for (k, a), b in zip(models[0].named_parameters(),
                             models[1].parameters()):
            assert torch.equal(a.grad, b.grad), k
            assert torch.equal(a, b), k
    e0, e1 = (s.eval_step(_batches(1, seed=5)[0]) for s in steps)
    for k in e0:
        assert torch.equal(e0[k], e1[k]), k


def test_multihost_helpers_on_one_rank(one_rank):
    assert one_rank.size == 1 and one_rank.rank == 0
    assert multihost.is_main(one_rank) and not multihost.active(one_rank)
    assert multihost.any_true(True, one_rank)
    assert not multihost.any_true(False, one_rank)
    multihost.barrier(one_rank)
    t = torch.arange(3.0)
    multihost.replicate([t, torch.tensor([7])], one_rank)
    assert torch.equal(t, torch.arange(3.0))
    batch = np.arange(12).reshape(4, 3)
    assert np.array_equal(multihost.shard_batch(batch, one_rank), batch)
    tree = multihost.host_local({"a": {"b": torch.ones(2)}, "n": 3})
    assert tree["n"] == 3 and torch.equal(tree["a"]["b"], torch.ones(2))


def test_shard_batch_takes_each_ranks_rows():
    batch = np.arange(24).reshape(6, 4)
    for r in range(3):
        mesh = ProcessMesh(rank=r, size=3, device=torch.device("cpu"))
        got = multihost.shard_batch(batch, mesh)
        assert np.array_equal(got, batch[2 * r:2 * r + 2])
        assert got.flags.c_contiguous


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    generate_synthetic_corpus(root, num_speakers=4, files_per_speaker=1,
                              seconds_per_file=1.0, seed=3)
    return root


def test_trainer_under_one_rank_mesh_is_bit_equal(corpus, tmp_path):
    cfg = _cfg(fuse_heads=True)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_every=1, checkpoint_every=2))
    ds = SnippetDataset(corpus, SAMPLES)
    runs = []
    for n, use_mesh in enumerate((False, True)):
        mesh = multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                    device="cpu") if use_mesh else None
        try:
            trainer = Trainer(cfg, ds, ds, workdir=str(tmp_path / str(n)),
                              device="cpu", mesh=mesh)
            last = trainer.train(3)
            val = trainer.validate(max_batches=2)
            trainer.close()
            resumed = Trainer(cfg, ds, workdir=str(tmp_path / str(n)),
                              device="cpu", mesh=mesh)
            assert resumed.maybe_resume() and resumed.step == 3
            runs.append((last, val, resumed.model.state_dict(),
                         resumed.batcher.state()))
            resumed.close()
        finally:
            multihost.shutdown()
    (a, va, sa, ba), (b, vb, sb, bb) = runs
    for k in ("loss", "acc", "grad_norm"):
        assert torch.equal(a[k], b[k]), k
    for k in va:
        assert torch.equal(va[k], vb[k]), k
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert ba == bb


def test_cli_with_a_coordinator_of_one_process(corpus, tmp_path):
    args = ["--config", "dp_global_negatives", "--data", corpus,
            "--device", "cpu", "--batch-size", str(B), "--snippet-samples",
            str(SAMPLES), "--steps", "2",
            "--set", "model.encoder.channels=16,16,16,16,16",
            "--set", "model.encoder.d_enc=16", "--set", "model.ar.d_ar=16",
            "--set", "model.loss.prediction_steps=2",
            "--set", "train.log_every=1"]
    losses = []
    for n, extra in enumerate(([], ["--coordinator",
                                    f"127.0.0.1:{free_port()}",
                                    "--num-processes", "1",
                                    "--process-id", "0"])):
        wd = tmp_path / str(n)
        assert cli.main([*args, "--workdir", str(wd), *extra]) == 0
        assert not dist.is_initialized()  # the CLI left the group it formed
        with open(wd / "metrics.jsonl") as f:
            losses.append([json.loads(line)["loss"] for line in f])
    assert losses[0] == losses[1]


# ----------------------------------------------------------- the dropout
def _dropout_generator_before_ranks(seed, count, microbatch, device):
    mixed = (seed * 0x9E3779B97F4A7C15 + count * 1_000_003 + microbatch)
    return torch.Generator(device=device).manual_seed(mixed % (1 << 63))


@pytest.mark.parametrize("seed,count,microbatch", [(0, 0, 0), (7, 3, 1),
                                                   (12345, 99, 3)])
def test_dropout_generator_rank_zero_draws_as_before(seed, count,
                                                     microbatch):
    def draws(gen):
        return torch.rand(64, generator=gen)
    before = draws(_dropout_generator_before_ranks(seed, count, microbatch,
                                                   "cpu"))
    assert torch.equal(draws(dropout_generator(seed, count, microbatch,
                                               "cpu")), before)
    assert torch.equal(draws(dropout_generator(seed, count, microbatch,
                                               "cpu", rank=0)), before)
    others = [draws(dropout_generator(seed, count, microbatch, "cpu",
                                      rank=r)) for r in (1, 2, 3)]
    for r, o in enumerate(others, 1):
        assert not torch.equal(o, before), r
    assert not torch.equal(others[0], others[1])


# ------------------------------------------------------------- the checks
def _mesh(size, rank=0):
    return ProcessMesh(rank=rank, size=size, device=torch.device("cpu"))


def _with(cfg, section, **fields):
    return dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **fields)})


@pytest.mark.parametrize("shape,world,want", [((-1,), 1, 1), ((-1,), 4, 4),
                                              ((2,), 2, 2), ((1,), 1, 1)])
def test_mesh_size(shape, world, want):
    assert mesh_size(shape, world) == want


@pytest.mark.parametrize("shape,mesh", [((2,), None), ((3,), 1), ((1,), 2)])
def test_mesh_shape_that_is_not_the_world_raises(shape, mesh):
    cfg = _with(_cfg(), "train", mesh_shape=shape)
    with pytest.raises(ValueError, match="span all"):
        make_step_fns(cfg, CPCModel(cfg.model),
                      None if mesh is None else _mesh(mesh))


def test_batch_the_world_does_not_divide_raises():
    cfg = _cfg()
    with pytest.raises(ValueError, match="not divisible by the 3-way data"):
        make_step_fns(cfg, CPCModel(cfg.model), _mesh(3))
    with pytest.raises(ValueError, match="not divisible by the 3-way data"):
        _mesh(3).rows(B)
    assert _mesh(2, rank=1).rows(B) == slice(2, 4)


def _cp_cfg(**train):
    cfg = _with(_cfg(negatives="all_steps", use_pallas=False), "model",
                ar=tcfg.ArConfig(kind="transformer", d_ar=8, num_layers=1,
                                 num_heads=2))
    return _with(cfg, "train", **train)


@pytest.mark.parametrize("section,fields", [
    ("train", dict(parallel="cp")),
    ("train", dict(parallel="dpcp", mesh_shape=(1, 1),
                   mesh_axes=("data", "ctx"))),
    ("train", dict(mesh_shape=(1, 1), mesh_axes=("data", "model"))),
    ("train", dict(mesh_shape=(1,), mesh_axes=("model",))),
])
def test_waiting_parallel_modes_name_a10(section, fields):
    # 'cp' and 'dpcp' run on a one-rank mesh, and so do 'model' axes under
    # 'dp' (replicas; tensor parallelism itself is parallel/tp.py, in
    # tests/test_torch_port_tp.py): no mode waits any more
    cfg = _cp_cfg(**fields)
    from cpc_tpu_torch.parallel.mesh import thread_meshes
    from cpc_tpu_torch.train.train_step import init_state
    model = init_state(cfg)
    # the DP step's averages need a group: a thread rank's of one
    mesh = (thread_meshes(1, "cpu")[0] if "model" in cfg.train.mesh_axes
            else _mesh(1))
    m = make_step_fns(cfg, model, mesh).train_step(_batches(1)[0])
    assert all(bool(torch.isfinite(v).all()) for v in m.values())


def test_loss_ring_under_a_mesh_names_a10():
    # loss.ring under a mesh sweeps the pool round the ranks: on two thread
    # ranks the step equals the gathered all-steps step (more worlds in
    # tests/test_torch_port_ring_infonce.py); without a mesh it is the
    # plain all-steps step
    from cpc_tpu_torch.ops.ring_util import run_thread_ranks
    from cpc_tpu_torch.parallel.mesh import groups_of, thread_meshes
    batch = _batches(1)[0]

    def run(ring, mesh):
        cfg = _cfg(negatives="all_steps", ring=ring)
        model = CPCModel(cfg.model, generator=torch.Generator().manual_seed(0))
        rows = batch if mesh is None else batch[mesh.rows(B)]
        return make_step_fns(cfg, model, mesh).train_step(rows)

    for ring in (True, False):
        meshes = thread_meshes(2, "cpu", timeout=60)
        got = run_thread_ranks(groups_of(meshes), [
            functools.partial(run, ring, m) for m in meshes], timeout=120)
        if ring:
            swept = got
    for a, b in zip(swept, got):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7)
    alone = run(True, None)
    assert all(bool(torch.isfinite(v).all()) for v in alone.values())


def test_a_run_across_hosts_names_a10d(monkeypatch):
    # a launcher's env:// with ranks on two hosts (two of four here) is
    # taken, not refused: the host's layout comes from LOCAL_RANK and
    # LOCAL_WORLD_SIZE before the group forms (runs across hosts in
    # tests/test_torch_port_multihost.py)
    for k, v in (("WORLD_SIZE", "4"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                 ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(k, v)
    seen = {}

    class Formed(Exception):
        pass

    def init(backend, **kw):
        seen.update(kw, backend=backend)
        raise Formed
    monkeypatch.setattr(multihost, "share_host_threads",
                        lambda n: seen.setdefault("local_world", n))
    monkeypatch.setattr(multihost.dist, "init_process_group", init)
    with pytest.raises(Formed):
        multihost.initialize(device="cpu")
    assert seen == {"init_method": "env://", "world_size": 4, "rank": 0,
                    "timeout": seen["timeout"], "backend": "gloo",
                    "local_world": 2}
    assert not dist.is_initialized()


def test_pool_and_mesh_together_raise():
    t = _loss_inputs()
    with pytest.raises(ValueError, match="not both"):
        _loss("fused", t, mesh=_mesh(1), shift=1, pool=t["z"])
    with pytest.raises(ValueError, match="not both"):
        _loss("same_step", t, mesh=_mesh(1), pool=t["z"])


@pytest.mark.parametrize("argv,match", [
    (["--coordinator", "127.0.0.1:1"], "requires --num-processes"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2"],
     "requires --num-processes"),
    (["--num-processes", "2", "--process-id", "0"], "need --coordinator"),
])
def test_cli_distributed_flags_are_checked(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["--device", "cpu", *argv])


@pytest.mark.parametrize("backend,device,local_world,n_devices,raises", [
    ("nccl", "cuda", 2, 1, True),     # two ranks, one card
    ("nccl", "cuda:0", 2, 2, True),   # every rank on the one named card
    ("nccl", "cuda", 2, 2, False),
    ("nccl", "cuda:0", 1, 1, False),
    ("gloo", "cuda:0", 2, 1, False),  # asked for by name: may share
    ("gloo", "cpu", 4, 0, False),
])
def test_two_nccl_ranks_on_one_card_raise(backend, device, local_world,
                                          n_devices, raises):
    if raises:
        with pytest.raises(ValueError, match="two ranks on one device"):
            check_one_rank_a_device(backend, device, local_world, n_devices)
    else:
        check_one_rank_a_device(backend, device, local_world, n_devices)


@pytest.mark.parametrize("local_world,env,want", [
    (1, None, "kept"), (4, None, 1), (4, "8", "kept")])
def test_ranks_sharing_a_host_take_one_thread_each(local_world, env, want,
                                                   monkeypatch):
    if env is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", env)
    before = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        multihost.share_host_threads(local_world)
        assert torch.get_num_threads() == (3 if want == "kept" else want)
    finally:
        torch.set_num_threads(before)


def test_rank_device():
    assert rank_device("cuda", 3) == torch.device("cuda", 3)
    assert rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert rank_device("cpu", 3) == torch.device("cpu")
