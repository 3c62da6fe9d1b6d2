"""The port's data parallelism across processes on the CPU (gloo): each
test spawns its ranks as processes (`tests/torch_dp_rank.py`, or the
training CLI), one torch thread each.

  * The port's two-rank step against JAX's data-parallel step
    (`cpc_tpu.train.train_step.make_step_fns(cfg, model, mesh)`) on a
    2-device slice of the conftest's 8 virtual CPU devices, from the same
    weights (carried by `from_jax_params`) on the same int16 batches: the
    fused heads, the same-step loss on materialized predictions (through
    the kernels' route and the plain one) and the all-steps loss, each with
    `loss.cross_replica` True and False, and `accum_steps=2` with a cosine
    schedule and clipping. JAX runs Pallas in interpret mode at
    `jax.default_matmul_precision('highest')`, fp32. Compared after each
    of two steps: loss, per-k accuracy and grad_norm; after the second, the
    gradient the update used and the parameters. The two ranks' parameters
    must be bit-equal.
  * The training CLI under `--coordinator` on 2 processes (4 under the
    `slow` marker) against one process on the global batch: the same loss
    trajectory; a resume in fresh processes continues the straight run bit
    for bit; rank 0 alone writes the workdir.

Tolerances (fp32; the two sides differ in summation order only, the DP
side also in the order of the ranks' averages): loss, acc_mean and
grad_norm 1e-5 relative, as JAX's own DP tests hold them; per-k accuracy
1e-7 absolute, the fp32 rounding of a mean of the ranks' shares (no
prediction may flip); each gradient 1e-4 relative to its largest entry, as
tests/test_torch_port_train_step.py holds the single-device step; the
parameters after Adam by that file's bound, 2 lr min(1, 2 e / |g|) a step
for a gradient error e.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc_tpu import config as jcfg
from cpc_tpu.models.cpc import CPCModel as JaxCPCModel
from cpc_tpu.parallel.mesh import make_mesh, replicated
from cpc_tpu.train.train_step import make_step_fns as jax_make_step_fns
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.interop import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_SCRIPT = os.path.join(REPO, "tests", "torch_dp_rank.py")
BATCH, SAMPLES, LR, STEPS = 4, 800, 2e-4, 2
SCALAR_TOL, GRAD_TOL, ACC_TOL = 1e-5, 1e-4, 1e-7
CASES = {  # name: (LossConfig fields, TrainConfig fields)
    "fused-cross": (dict(fuse_heads=True), {}),
    "fused-local": (dict(fuse_heads=True, cross_replica=False), {}),
    "same_step-cross": ({}, {}),
    "same_step-local": (dict(cross_replica=False), {}),
    "same_step-plain-cross": (dict(use_pallas=False), {}),
    "all_steps-cross": (dict(negatives="all_steps"), {}),
    "all_steps-local": (dict(negatives="all_steps", cross_replica=False), {}),
    "fused-cross-accum2-cosine-clip": (
        dict(fuse_heads=True),
        dict(accum_steps=2, lr_schedule="cosine", num_steps=4,
             grad_clip_norm=0.05)),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cmds, log_dir, timeout=240.0):
    """Runs one process a command, one torch thread each; kills them all
    if one fails or the time runs out. Returns each one's stdout."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for i, cmd in enumerate(cmds):
        out = open(os.path.join(log_dir, f"rank{i}.out"), "w+")
        err = open(os.path.join(log_dir, f"rank{i}.err"), "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out,
                                      stderr=err, text=True))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
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
        assert rc == 0, f"rank {i} exited {rc}\n{out}\n{err[-4000:]}"
    return [out for _, out, _ in texts]


def _cfg(loss, train):
    return jcfg.CPCConfig(
        name="tiny",
        model=jcfg.ModelConfig(
            encoder=jcfg.EncoderConfig(channels=(16, 16), kernels=(10, 8),
                                       strides=(5, 4), d_enc=16),
            ar=jcfg.ArConfig(d_ar=8),
            loss=jcfg.LossConfig(**{"prediction_steps": 2,
                                    "use_pallas": True, **loss})),
        data=jcfg.DataConfig(batch_size=BATCH, snippet_samples=SAMPLES),
        train=jcfg.TrainConfig(learning_rate=LR, **train))


def _params(cfg, seed=0):
    shapes = jax.eval_shape(JaxCPCModel(cfg.model).init, jax.random.key(0),
                            jnp.zeros((1, SAMPLES)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key in ("bias", "bi", "bh"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                ).astype(np.float32)
    return {"params": jax.tree_util.tree_map_with_path(draw, shapes)}


def _batches(seed=1):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((STEPS, BATCH, SAMPLES)) * 6000,
                   -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case's two-rank run, in one pair of processes."""
    d = str(tmp_path_factory.mktemp("dp_cases"))
    cfgs = {name: _cfg(*spec) for name, spec in CASES.items()}
    with open(os.path.join(d, "cases.json"), "w") as f:
        json.dump({name: jcfg.to_dict(c) for name, c in cfgs.items()}, f)
    any_cfg = next(iter(cfgs.values()))
    state = from_jax_params(_params(any_cfg),
                            tcfg.from_dict(jcfg.to_dict(any_cfg)))
    torch.save(state, os.path.join(d, "state.pt"))
    np.save(os.path.join(d, "batches.npy"), _batches())
    port = free_port()
    run_ranks([[sys.executable, RANK_SCRIPT, "--rank", str(r), "--world", "2",
                "--port", str(port), "--dir", d] for r in range(2)], d)
    return d


def _jax_grads(cfg, grad_fn, params, batch):
    """The gradient JAX's DP step averages, from one device: the global
    loss's (cross-replica pools, or no accumulation), else the mean over
    ranks and microbatches of each one's loss on its own rows."""
    accum, half = cfg.train.accum_steps, BATCH // 2
    if cfg.model.loss.cross_replica and accum == 1:
        return grad_fn(params, jnp.asarray(batch))
    if cfg.model.loss.cross_replica:
        # microbatch i gathers rank r's i-th microbatch from every rank
        mb = half // accum
        pools = [np.concatenate([batch[r * half + i * mb:
                                       r * half + (i + 1) * mb]
                                 for r in range(2)]) for i in range(accum)]
    else:
        mb = half // accum
        pools = [batch[j * mb:(j + 1) * mb] for j in range(BATCH // mb)]
    gs = [grad_fn(params, jnp.asarray(p)) for p in pools]
    return jax.tree.map(lambda *x: sum(x) / len(gs), *gs)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_step_matches_jax_dp(case, port_runs):
    cfg = _cfg(*CASES[case])
    tc = tcfg.from_dict(jcfg.to_dict(cfg))
    mesh = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    jsteps = jax_make_step_fns(cfg, JaxCPCModel(cfg.model), mesh)
    # committed to the mesh from the start, so that no step recompiles
    params = jax.device_put(_params(cfg), replicated(mesh))
    opt_state = jax.device_put(jsteps.optimizer.init(params),
                               replicated(mesh))
    ranks = [np.load(os.path.join(port_runs, f"{case}.rank{r}.npz"))
             for r in range(2)]
    got = ranks[0]
    for k in got.files:  # the ranks hold the same values, bit for bit
        np.testing.assert_array_equal(ranks[1][k], got[k], err_msg=k)
    sens = {}
    grad_fn = jax.jit(jax.grad(lambda p, b: jsteps.loss_fn(p, b)[0]))
    with jax.default_matmul_precision("highest"):
        for n, batch in enumerate(_batches()):
            jgrads = _jax_grads(cfg, grad_fn, params, batch)
            params, opt_state, jm = jsteps.train_step(params, opt_state,
                                                      jnp.asarray(batch))
            for k in ("loss", "acc_mean", "grad_norm"):
                np.testing.assert_allclose(got[f"{n}/{k}"], float(jm[k]),
                                           rtol=SCALAR_TOL,
                                           err_msg=f"step {n} {k}")
            np.testing.assert_allclose(got[f"{n}/acc"], np.asarray(jm["acc"]),
                                       rtol=0, atol=ACC_TOL)
            want_g = from_jax_params(jax.tree.map(np.asarray, jgrads), tc)
            for name, w in want_g.items():
                e = GRAD_TOL * np.abs(w.numpy()).max()
                step = np.minimum(1.0, 2 * e / np.maximum(
                    np.abs(w.numpy()), 1e-30))
                sens[name] = np.maximum(sens.get(name, 0.0), step)
    for name, w in want_g.items():  # the last step's gradient
        assert _rel(got[f"grad/{name}"], w.numpy()) <= GRAD_TOL, name
    want_p = from_jax_params(jax.tree.map(np.asarray, params), tc)
    for name, w in want_p.items():
        d = np.abs(got[f"param/{name}"] - w.numpy())
        bound = 2 * LR * STEPS * sens[name] + 1e-6
        assert (d <= bound).all(), (name, (d - bound).max())


# ------------------------------------------------------------ the CLI
CLI_BATCH, CLI_SAMPLES, CLI_STEPS = 8, 2560, 10
TINY = ["--device", "cpu", "--batch-size", str(CLI_BATCH),
        "--snippet-samples", str(CLI_SAMPLES),
        "--set", "model.encoder.channels=16,16,16,16,16",
        "--set", "model.encoder.d_enc=16", "--set", "model.ar.d_ar=16",
        "--set", "model.loss.prediction_steps=3",
        "--set", "model.dtype=float32", "--set", "model.loss.pallas_bf16=false",
        "--set", "train.log_every=1"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_corpus"))
    generate_synthetic_corpus(root, num_speakers=4, files_per_speaker=2,
                              seconds_per_file=1.0, seed=7)
    return root


def train(corpus, workdir, nprocs, steps, *extra):
    """The training CLI on `nprocs` ranks (one process without a
    coordinator); returns each rank's stdout."""
    base = [sys.executable, "-m", "cpc_tpu_torch.train", "--config",
            "dp_global_negatives", "--data", corpus, "--workdir", workdir,
            "--steps", str(steps), *TINY, *extra]
    if nprocs == 1:
        return run_ranks([base], os.path.dirname(workdir))
    port = free_port()
    return run_ranks([base + ["--coordinator", f"127.0.0.1:{port}",
                              "--num-processes", str(nprocs),
                              "--process-id", str(r)]
                      for r in range(nprocs)], os.path.dirname(workdir))


def records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def single_run(corpus, tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("single") / "wd")
    train(corpus, wd, 1, CLI_STEPS)
    return records(wd)


@pytest.fixture(scope="module")
def two_rank_run(corpus, tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("two") / "wd")
    outs = train(corpus, wd, 2, CLI_STEPS)
    return wd, outs


def _losses(recs):
    return {r["step"]: r["loss"] for r in recs if r["prefix"] == "train"}


def _check_trajectory(recs, single):
    got, want = _losses(recs), _losses(single)
    assert sorted(got) == sorted(want) == list(range(1, CLI_STEPS + 1))
    for step in want:
        np.testing.assert_allclose(got[step], want[step], rtol=SCALAR_TOL,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("nprocs", [2, pytest.param(4,
                                                    marks=pytest.mark.slow)])
def test_cli_trajectory_matches_single_process(nprocs, corpus, single_run,
                                               two_rank_run, tmp_path):
    if nprocs == 2:
        wd = two_rank_run[0]
    else:
        wd = str(tmp_path / "wd")
        train(corpus, wd, nprocs, CLI_STEPS)
    _check_trajectory(records(wd), single_run)


def test_cli_resume_in_fresh_processes_continues_bit_for_bit(
        corpus, two_rank_run, tmp_path):
    straight = _losses(records(two_rank_run[0]))
    wd = str(tmp_path / "wd")
    train(corpus, wd, 2, 5)
    outs = train(corpus, wd, 2, CLI_STEPS, "--resume")
    assert "resume: restored step 5" in outs[0]
    resumed = _losses(records(wd))
    assert sorted(resumed) == list(range(1, CLI_STEPS + 1))
    for step in range(1, CLI_STEPS + 1):
        assert resumed[step] == straight[step], step
    a, b = (torch.load(os.path.join(w, "checkpoints",
                                     f"step_{CLI_STEPS}.pt"))
            for w in (two_rank_run[0], wd))
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    assert a["meta"] == b["meta"]


def test_cli_rank_zero_alone_writes_the_workdir(two_rank_run):
    wd, outs = two_rank_run
    steps = [r["step"] for r in records(wd) if r["prefix"] == "train"]
    assert steps == list(range(1, CLI_STEPS + 1))  # each record once
    assert "config=dp_global_negatives device=cpu processes=2" in outs[0]
    assert not [line for line in outs[1].splitlines() if line.strip()]
    names = sorted(os.listdir(wd))
    assert names == ["checkpoints", "config.json", "metrics.jsonl",
                     "tb"], names
    # one TensorBoard event file: rank 0's
    assert len(os.listdir(os.path.join(wd, "tb"))) == 1
    assert not [n for n in os.listdir(os.path.join(wd, "checkpoints"))
                if not n.endswith(".pt")]
    with open(os.path.join(wd, "config.json")) as f:
        cfg = tcfg.from_dict(json.load(f))
    assert cfg.data.batch_size == CLI_BATCH  # the global batch
    assert dataclasses.asdict(cfg.model.loss)["cross_replica"] is True
