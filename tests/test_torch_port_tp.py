"""The port's tensor parallelism (`cpc_tpu_torch/parallel/tp.py`) against
the JAX package's (`cpc_tpu.parallel.tp.make_tp_train_step`, GSPMD on the
conftest's 8 virtual CPU devices), with the port's ranks played by threads
(`mesh.thread_meshes(..., model=m)`, `ring_util.run_thread_ranks`):

  * one TP step from the same weights (carried by `from_jax_params`) on the
    same int16 batch, for tests/test_tp.py's configs (tiny on (4, 2); the
    5 x 512 encoder with d_ar 256 on (2, 4), 12 sharded parameters; the
    transformer gar on (2, 2), 25; the non-divisible conv on (1, 8)) and a
    tiny scalogram model and a 'batch'-norm encoder on (2, 2): the loss at
    rtol 1e-5, the whole parameters after the step (`gather_params`) at
    rtol 1e-3 with atol 5e-4, JAX's own bounds (Adam turns a near-zero
    gradient's sign flip into +-lr);
  * `sharded_param_paths` against JAX's, through the interop names; the
    warning of a width the model axis does not divide; each rank's slices;
    the Adam moments sharded like their parameters; replicated gradients
    equal on every model rank; remat equal to no remat;
  * a bf16 model with `ar.use_pallas` within the GRU's 2e-2 band of JAX's
    bf16 step; two gloo processes equal to the thread ranks;
  * the mesh with a 'model' axis (data-major layout, its rings, the checks)
    and a 'model' axis under train.parallel='dp': replicas, equal to pure
    data parallelism (thread ranks, and the training CLI on two gloo
    processes against one);
  * the TP step's checks.

JAX at `jax.default_matmul_precision('highest')`, fp32; one torch thread.
"""

import dataclasses
import functools
import json
import os
import re
import socket
import subprocess
import sys
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc_tpu import config as jcfg
from cpc_tpu.data.loader import device_prepare as j_prepare
from cpc_tpu.models.cpc import CPCModel as JModel
from cpc_tpu.ops.infonce import infonce_loss_and_metrics as j_infonce
from cpc_tpu.parallel import tp as jtp
from cpc_tpu.parallel.mesh import make_mesh
from cpc_tpu.train.train_step import init_state as j_init_state
from cpc_tpu.train.train_step import make_step_fns as j_make_step_fns
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.interop import from_jax_params
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.ops.ring_util import run_thread_ranks
from cpc_tpu_torch.parallel import tp
from cpc_tpu_torch.parallel.mesh import (ProcessMesh, axis_sizes, groups_of,
                                         thread_meshes)
from cpc_tpu_torch.train import cli
from cpc_tpu_torch.train.train_step import make_step_fns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=5e-4)
# each gradient relative to its largest entry, as the single-device and DP
# steps are held (tests/test_torch_port_multiprocess.py)
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-3
BF16_BAND = 2e-2


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


# ----------------------------------------------------------------- configs
def _tiny(**enc):
    return jcfg.CPCConfig(
        model=jcfg.ModelConfig(
            encoder=jcfg.EncoderConfig(channels=(16, 16), kernels=(10, 8),
                                       strides=(5, 4), d_enc=16, **enc),
            ar=jcfg.ArConfig(d_ar=8), loss=jcfg.LossConfig(prediction_steps=2)),
        data=jcfg.DataConfig(batch_size=16, snippet_samples=2000),
        train=jcfg.TrainConfig(seed=0))


def _realistic():
    return jcfg.CPCConfig(
        model=jcfg.ModelConfig(encoder=jcfg.EncoderConfig(),
                               ar=jcfg.ArConfig(d_ar=256),
                               loss=jcfg.LossConfig(prediction_steps=2)),
        data=jcfg.DataConfig(batch_size=4, snippet_samples=3200),
        train=jcfg.TrainConfig(seed=0))


def _transformer():
    return jcfg.CPCConfig(
        model=jcfg.ModelConfig(
            encoder=jcfg.EncoderConfig(channels=(32, 32), kernels=(10, 8),
                                       strides=(5, 4), d_enc=32),
            ar=jcfg.ArConfig(kind="transformer", d_ar=32, num_layers=2,
                             num_heads=4),
            loss=jcfg.LossConfig(prediction_steps=2)),
        data=jcfg.DataConfig(batch_size=8, snippet_samples=2000),
        train=jcfg.TrainConfig(seed=0))


def _nondivisible():
    return jcfg.CPCConfig(
        model=jcfg.ModelConfig(
            encoder=jcfg.EncoderConfig(channels=(12,), kernels=(10,),
                                       strides=(5,), d_enc=12),
            ar=jcfg.ArConfig(d_ar=8), loss=jcfg.LossConfig(prediction_steps=2)),
        data=jcfg.DataConfig(batch_size=8, snippet_samples=1000))


def _scalogram():
    enc = jcfg.EncoderConfig(
        kind="scalogram", scalogram_n_fft=256, scalogram_hop=64,
        scalogram_n_bins=24, scalogram_fmin=60.0, scalogram_fmax=7000.0,
        scalogram_channels=(4, 8), scalogram_kernels=((3, 3), (3, 3)),
        scalogram_freq_strides=(2, 2), scalogram_time_strides=(1, 1),
        d_enc=10, norm="group")
    return jcfg.CPCConfig(
        model=jcfg.ModelConfig(encoder=enc, ar=jcfg.ArConfig(d_ar=8),
                               loss=jcfg.LossConfig(prediction_steps=2)),
        data=jcfg.DataConfig(batch_size=8, snippet_samples=1280),
        train=jcfg.TrainConfig(seed=0))


# name: (config, (data, model), sharded parameters)
CASES = {
    "tiny": (_tiny, (4, 2), 6),
    "realistic": (_realistic, (2, 4), 12),
    "transformer": (_transformer, (2, 2), 25),
    "nondivisible": (_nondivisible, (1, 8), 1),
    "scalogram": (_scalogram, (2, 2), 6),
    "batch_norm": (functools.partial(_tiny, norm="batch"), (2, 2), 6),
}


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal(
        (cfg.data.batch_size, cfg.data.snippet_samples)) * 8000,
        -32768, 32767).astype(np.int16)


def _jax_grads(cfg, model, params, batch):
    """The gradient of the function JAX's TP step differentiates (GSPMD
    partitions it; the function is the single-device one)."""
    def loss(params):
        x = j_prepare(jnp.asarray(batch), normalize=cfg.data.normalize)
        out = model.apply(params, x)
        return j_infonce(out.preds, out.z,
                         negatives=cfg.model.loss.negatives)[0]
    return jax.tree.map(np.asarray, jax.grad(loss)(params))


def _jax_tp(cfg, shape, batch):
    """JAX's TP step: (the initial params as numpy, the params after one
    step, its metrics, its sharded paths, the step's gradient)."""
    model = JModel(cfg.model)
    mesh = make_mesh(shape, ("data", "model"),
                     devices=jax.devices()[:shape[0] * shape[1]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        step, shard_fn, batch_sharding, opt = jtp.make_tp_train_step(
            cfg, model, mesh)
        params, opt_state = j_init_state(cfg, model, opt)
        paths = jtp.sharded_param_paths(params, mesh)
        p0 = jax.tree.map(np.asarray, params)
        grads = _jax_grads(cfg, model, p0, batch)
        params, opt_state = shard_fn(params, opt_state)
    p1, _, m1 = step(params, opt_state, jax.device_put(batch, batch_sharding))
    return p0, jax.tree.map(np.asarray, p1), m1, paths, grads


def ranks(d, m, fn):
    """fn(mesh) on d * m thread ranks, m of them to a data row."""
    meshes = thread_meshes(d * m, "cpu", model=m, timeout=120)
    return run_thread_ranks(groups_of(meshes),
                            [functools.partial(fn, x) for x in meshes],
                            timeout=300)


def _port_tp(cfg, shape, state, batch):
    """The port's TP step on thread ranks: each rank's (metrics, whole
    params after the step, model, step fns, the whole gradient the update
    used)."""
    def rank(mesh):
        model = CPCModel(cfg.model)
        model.load_state_dict(state)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            step = tp.make_tp_train_step(cfg, model, mesh)
        seen, update = {}, step.optimizer.step

        def spy(grads):
            seen.update(grads)
            update(grads)
        step.optimizer.step = spy
        rows = torch.from_numpy(batch[mesh.rows(len(batch))])
        metrics = step.train_step(rows)
        step.optimizer.step = update
        return (metrics, tp.gather_params(model, mesh), model, step,
                tp.gather_params(model, mesh, seen))
    return ranks(*shape, rank)


@pytest.fixture(scope="module")
def runs():
    """Each case's JAX and port steps, once."""
    cache = {}

    def get(name):
        if name not in cache:
            make, shape, _ = CASES[name]
            jc = make()
            batch = _batch(jc)
            p0, p1, m1, paths, grads = _jax_tp(jc, shape, batch)
            tc = tcfg.from_dict(jcfg.to_dict(jc))
            got = _port_tp(tc, shape, from_jax_params(p0, tc), batch)
            cache[name] = (jc, tc, p1, m1, paths, got,
                           from_jax_params(grads, tc))
        return cache[name]
    return get


# ---------------------------------------------------------- against JAX
@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_jax(name, runs):
    jc, tc, p1, m1, _, got, jgrads = runs(name)
    want = from_jax_params(p1, tc)
    np.testing.assert_allclose(float(got[0][0]["loss"]), float(m1["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(got[0][0]["acc"].numpy(),
                               np.asarray(m1["acc"]), atol=1e-6)
    norm = np.sqrt(sum(float(np.sum(g.numpy().astype(np.float64) ** 2))
                       for g in jgrads.values()))
    np.testing.assert_allclose(float(got[0][0]["grad_norm"]), norm,
                               rtol=1e-5)
    for metrics, params, _, _, grads in got:
        assert set(params) == set(want)
        for k in want:
            np.testing.assert_allclose(params[k].numpy(), want[k].numpy(),
                                       err_msg=k, **PARAM_TOL)
            # the gradient the update used, to 1e-4 of its largest entry
            # (floored at 1e-3: a gradient that is zero by symmetry, a bias
            # before a norm or the attention's key bias, is rounding noise)
            scale = max(float(jgrads[k].abs().max()), GRAD_FLOOR)
            err = float((grads[k] - jgrads[k]).abs().max()) / scale
            assert err <= GRAD_TOL, (k, err)
    # every rank holds the same whole parameters and metrics
    for metrics, params, _, _, _ in got[1:]:
        for k in params:
            assert torch.equal(params[k], got[0][1][k]), k
        for k in metrics:
            assert torch.equal(metrics[k], got[0][0][k]), k


_JAX_NAMES = [  # flax path -> the port's name, as from_jax_params maps them
    (r"^params/", ""), (r"/", "."), (r"kernel$", "weight"),
    (r"MultiHeadDotProductAttention_0", "attn"), (r"Dense_0", "fc1"),
    (r"Dense_1", "fc2")]


def _port_name(path: str) -> str:
    for pat, rep in _JAX_NAMES:
        path = re.sub(pat, rep, path)
    return path


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_param_paths_equal_jax(name, runs):
    _, tc, _, _, paths, got, _ = runs(name)
    model, shape = got[0][2], CASES[name][1]
    ours = tp.sharded_param_paths(model, thread_meshes(
        shape[0] * shape[1], "cpu", model=shape[1])[0])
    assert set(ours) == {_port_name(p) for p in paths}, (sorted(ours),
                                                         sorted(paths))
    assert len(ours) == CASES[name][2]
    assert all(m == shape[1] for _, m in ours.values())


def test_tp_nondivisible_width_warns():
    tc = tcfg.from_dict(jcfg.to_dict(_nondivisible()))
    model = CPCModel(tc.model, generator=torch.Generator().manual_seed(0))
    mesh = thread_meshes(8, "cpu", model=8)[3]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tp.shard_params(model, mesh)  # 12 % 8 != 0
    assert any("not divisible" in str(w.message) for w in rec), \
        [str(w.message) for w in rec]
    assert "encoder.conv0.weight" not in model.tp_shards
    assert model.encoder.conv0.weight.shape == (12, 1, 10)
    # neither does the GRU's wi (12 rows); the heads' 2 x 12 outputs do:
    # what shards is what JAX shards
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        j = jtp.sharded_param_paths(JModel(_nondivisible().model).init(
            jax.random.key(0), jnp.zeros((2, 1000))), make_mesh(
                (1, 8), ("data", "model")))
    assert set(model.tp_shards) == {_port_name(p) for p in j}


def test_shard_params_places_on_model_axis(runs):
    _, tc, _, _, _, got, _ = runs("tiny")
    full = CPCModel(tc.model, generator=torch.Generator().manual_seed(0))
    for r, (_, _, model, _, _) in enumerate(got):
        mesh = thread_meshes(8, "cpu", model=2)[r]
        heads = model.prediction_heads.weight
        assert heads.shape == (2 * 16 // 2, 8)
        conv0 = model.encoder.conv0.weight
        assert conv0.shape == (8, 1, 10)
        assert model.tp_shards["encoder.conv0.weight"] == (0, 2)
        assert model.tp_shards["gar.layer0.wi"] == (0, 2)
        assert model.gar.layer0.wh.shape == full.gar.layer0.wh.shape
        assert mesh.model_rank == r % 2 and mesh.data_rank == r // 2


@pytest.mark.parametrize("name", ["tiny", "transformer"])
def test_tp_optimizer_state_sharded(name, runs):
    got = runs(name)[5]
    for _, _, model, step, _ in got:
        opt = step.optimizer
        sharded = model.tp_shards
        assert sharded
        for k, p in model.named_parameters():
            assert opt.mu[k].shape == p.shape == opt.nu[k].shape, k
        for k, (dim, m) in sharded.items():
            assert opt.mu[k].shape[dim] * m == \
                dict(CPCModel(runs(name)[1].model).named_parameters()
                     )[k].shape[dim]


@pytest.mark.parametrize("name", ["tiny", "transformer", "batch_norm"])
def test_replicated_grads_equal_across_model_ranks(name, runs):
    _, tc, _, _, _, got, _ = runs(name)
    m = CASES[name][1][1]
    for r in range(0, len(got), m):
        row = [got[r + j][2] for j in range(m)]
        for k, p in row[0].named_parameters():
            if k in row[0].tp_shards:
                continue
            for other in row[1:]:
                g = dict(other.named_parameters())[k].grad
                assert torch.equal(p.grad, g), k


def test_remat_equals_no_remat():
    jc = _transformer()
    tc = tcfg.from_dict(jcfg.to_dict(jc))
    tc = dataclasses.replace(tc, model=dataclasses.replace(
        tc.model, ar=dataclasses.replace(tc.model.ar, remat=True),
        encoder=dataclasses.replace(tc.model.encoder, remat=True)))
    state = CPCModel(tc.model, generator=torch.Generator().manual_seed(0)
                     ).state_dict()
    batch = _batch(jc)
    plain = dataclasses.replace(tc, model=dataclasses.replace(
        tc.model, ar=dataclasses.replace(tc.model.ar, remat=False),
        encoder=dataclasses.replace(tc.model.encoder, remat=False)))
    a = _port_tp(tc, (2, 2), state, batch)
    b = _port_tp(plain, (2, 2), state, batch)
    for (ma, pa, _, _, _), (mb, pb, _, _, _) in zip(a, b):
        for k in mb:
            torch.testing.assert_close(ma[k], mb[k], rtol=1e-6, atol=1e-7)
        for k in pb:
            torch.testing.assert_close(pa[k], pb[k], rtol=1e-6, atol=1e-7)


def test_bf16_use_pallas_gru_within_the_band():
    """bf16 compute with ar.use_pallas: the port's TP step (the GRU on
    gru_scan on every rank, the wi partials summed in fp32) against JAX's
    bf16 single-device step with the Pallas GRU in interpret mode (GSPMD's
    TP step computes the single-device function): loss, grad_norm and
    the context within the GRU's 2e-2 band."""
    jc = _tiny()
    jc = dataclasses.replace(jc, model=dataclasses.replace(
        jc.model, dtype="bfloat16", ar=dataclasses.replace(
            jc.model.ar, use_pallas=True)), data=dataclasses.replace(
        jc.data, batch_size=8))
    tc = tcfg.from_dict(jcfg.to_dict(jc))
    batch = _batch(jc)
    jmodel = JModel(jc.model)
    steps = j_make_step_fns(jc, jmodel, None)
    params, opt_state = j_init_state(jc, jmodel, steps.optimizer)
    p0 = jax.tree.map(np.asarray, params)
    (loss, _), grads = jax.value_and_grad(steps.loss_fn, has_aux=True)(
        params, jnp.asarray(batch))
    jnorm = float(jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                               for g in jax.tree.leaves(grads))))
    from cpc_tpu.data.loader import device_prepare as j_prepare
    jc_ctx = np.asarray(jmodel.apply(params, j_prepare(
        jnp.asarray(batch), normalize=True)).c, np.float32)
    state = from_jax_params(p0, tc)

    def rank(mesh):
        model = CPCModel(tc.model)
        model.load_state_dict(state)
        step = tp.make_tp_train_step(tc, model, mesh)
        rows = torch.from_numpy(batch[mesh.rows(len(batch))])
        from cpc_tpu_torch.data.loader import device_prepare
        with torch.no_grad():
            c = tp.tp_forward(model, device_prepare(rows, normalize=True),
                              mesh).c.float()
        return step.train_step(rows), c
    got = ranks(2, 2, rank)
    m = got[0][0]
    assert abs(float(m["loss"]) - float(loss)) <= BF16_BAND * abs(
        float(loss))
    assert abs(float(m["grad_norm"]) - jnorm) <= BF16_BAND * jnorm
    c = torch.cat([got[0][1], got[2][1]]).numpy()
    assert np.abs(c - jc_ctx).max() <= BF16_BAND * max(
        1.0, np.abs(jc_ctx).max())


# ------------------------------------------------------- two processes
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(cmds, log_dir, env=None, timeout=240.0):
    """Runs one process a command, one torch thread each; kills them all
    if one fails or the time runs out. Returns each one's stdout."""
    base = dict(os.environ, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for i, cmd in enumerate(cmds):
        out = open(os.path.join(log_dir, f"p{i}.out"), "w+")
        err = open(os.path.join(log_dir, f"p{i}.err"), "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=dict(base, **(env[i] if env else {})),
            stdout=out, stderr=err, text=True))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for p, (out, err) in zip(procs, logs):
        out.seek(0)
        err.seek(0)
        texts.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    for i, (rc, out, err) in enumerate(texts):
        assert rc == 0, f"process {i} exited {rc}\n{out}\n{err[-4000:]}"
    return [out for _, out, _ in texts]


def test_two_gloo_processes_equal_thread_ranks(tmp_path):
    jc = _tiny()
    tc = tcfg.from_dict(jcfg.to_dict(jc))
    state = CPCModel(tc.model, generator=torch.Generator().manual_seed(0)
                     ).state_dict()
    batch = _batch(jc)
    (tmp_path / "cfg.json").write_text(json.dumps(tcfg.to_dict(tc)))
    torch.save(state, tmp_path / "state.pt")
    np.save(tmp_path / "batch.npy", batch)
    port = _free_port()
    _run([[sys.executable, os.path.join(REPO, "tests", "torch_tp_rank.py"),
           "--rank", str(r), "--world", "2", "--model", "2", "--port",
           str(port), "--dir", str(tmp_path)] for r in range(2)],
         str(tmp_path))
    threads = _port_tp(tc, (1, 2), state, batch)
    for r in range(2):
        proc = torch.load(tmp_path / f"rank{r}.pt")
        metrics, params = threads[r][0], threads[r][1]
        for k in metrics:
            assert torch.equal(proc["metrics"][k], metrics[k]), k
        for k in params:
            assert torch.equal(proc["params"][k], params[k]), k


# ------------------------------------------------------------------ mesh
def test_mesh_with_a_model_axis():
    meshes = thread_meshes(6, "cpu", model=3)
    for r, m in enumerate(meshes):
        assert (m.data, m.model, m.ctx) == (2, 3, 1)
        assert m.rank == m.data_rank * 3 + m.model_rank
        assert m.ring("model").size == 3 and m.ring("model").index == r % 3
        assert m.ring("data").size == 2 and m.ring("data").index == r // 3
        assert m.ring("ctx").size == 1
        dm = m.data_mesh()
        assert (dm.rank, dm.size) == (r // 3, 2)
        assert dm.group is m.data_group
        assert m.rows(8) == slice(4 * (r // 3), 4 * (r // 3) + 4)
    assert axis_sizes((2, -1), ("data", "model"), 8) == {
        "data": 2, "ctx": 1, "model": 4}
    with pytest.raises(ValueError, match="do not combine"):
        axis_sizes((2, 2, 1), ("data", "ctx", "model"), 4)
    with pytest.raises(ValueError, match="not both"):
        thread_meshes(4, "cpu", ctx=2, model=2)
    with pytest.raises(ValueError, match="not both"):
        ProcessMesh(rank=0, size=4, device=torch.device("cpu"), ctx=2,
                    model=2)


@pytest.mark.parametrize("field,value,match", [
    ("accum_steps", 2, "accum_steps"),
    ("augment", True, "augment"),
    ("dropout", 0.1, "dropout"),
    ("use_pallas", True, "use_pallas"),
    ("attn_impl", "ring", "ring"),
])
def test_tp_checks_raise(field, value, match):
    tc = tcfg.from_dict(jcfg.to_dict(_transformer()))
    section = {"accum_steps": "train", "augment": "data"}.get(field)
    if section == "train":
        tc = dataclasses.replace(tc, train=dataclasses.replace(
            tc.train, **{field: value}))
    elif section == "data":
        tc = dataclasses.replace(tc, data=dataclasses.replace(
            tc.data, **{field: value}))
    elif field == "use_pallas":
        tc = dataclasses.replace(tc, model=dataclasses.replace(
            tc.model, encoder=dataclasses.replace(tc.model.encoder,
                                                  use_pallas=True)))
    else:
        tc = dataclasses.replace(tc, model=dataclasses.replace(
            tc.model, ar=dataclasses.replace(tc.model.ar, **{field: value})))
    model = CPCModel(dataclasses.replace(tc.model, ar=dataclasses.replace(
        tc.model.ar, attn_impl="xla", dropout=0.0)))
    with pytest.raises(ValueError, match=match):
        tp.make_tp_train_step(tc, model, thread_meshes(2, "cpu", model=2)[0])
    assert getattr(model, "tp_shards", None) is None


# --------------------------------------------------- 'model' under 'dp'
def test_model_axis_under_dp_is_replicas():
    """train.parallel='dp' on a (2, 2) mesh: the model ranks step on the
    same rows and the collectives run over 'data', so every rank equals
    the (2,) DP step's rank of its data row, bit for bit."""
    jc = _tiny()
    tc = tcfg.from_dict(jcfg.to_dict(jc))
    tc = dataclasses.replace(tc, data=dataclasses.replace(tc.data,
                                                          batch_size=8))
    batch = torch.from_numpy(_batch(tc))

    def rank(cfg, mesh):
        model = CPCModel(cfg.model, generator=torch.Generator().manual_seed(0))
        metrics = make_step_fns(cfg, model, mesh).train_step(
            batch[mesh.rows(len(batch))])
        return metrics, {k: p.detach().clone()
                         for k, p in model.named_parameters()}
    replicas = dataclasses.replace(tc, train=dataclasses.replace(
        tc.train, mesh_shape=(2, 2), mesh_axes=("data", "model")))
    got = ranks(2, 2, functools.partial(rank, replicas))
    meshes = thread_meshes(2, "cpu", timeout=60)
    want = run_thread_ranks(groups_of(meshes), [
        functools.partial(rank, tc, m) for m in meshes], timeout=120)
    for r, (metrics, params) in enumerate(got):
        wm, wp = want[r // 2]
        for k in wm:
            assert torch.equal(metrics[k], wm[k]), k
        for k in wp:
            assert torch.equal(params[k], wp[k]), k


def _cli_argv(workdir, corpus, extra=()):
    return ["--config", "tpu_fast", "--data", corpus, "--steps", "3",
            "--workdir", workdir, "--device", "cpu", "--batch-size", "4",
            "--snippet-samples", "1600",
            "--set", "model.encoder.channels=8,8,8,8,8",
            "--set", "model.encoder.d_enc=8", "--set", "model.ar.d_ar=8",
            "--set", "model.loss.prediction_steps=2",
            "--set", "model.dtype=float32",
            "--set", "model.loss.pallas_bf16=false", *extra]


def _losses(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["loss"] for r in rows if r["prefix"] == "train"]


def test_cli_model_axis_under_dp_equals_one_process(tmp_path):
    corpus = str(tmp_path / "corpus")
    generate_synthetic_corpus(corpus, num_speakers=8, files_per_speaker=2,
                              seconds_per_file=1.0, seed=0)
    one = str(tmp_path / "one")
    assert cli.main(_cli_argv(one, corpus, ["--set", "train.log_every=1"])
                    ) == 0
    two = str(tmp_path / "two")
    port = _free_port()
    _run([[sys.executable, "-m", "cpc_tpu_torch.train",
           *_cli_argv(two, corpus, [
               "--set", "train.log_every=1", "--set",
               "train.mesh_shape=1,2", "--set", "train.mesh_axes=data,model",
               "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
               "--process-id", str(r)])] for r in range(2)], str(tmp_path))
    a, b = _losses(one), _losses(two)
    assert len(a) == len(b) == 3
    np.testing.assert_allclose(b, a, rtol=1e-7)
