"""Runs across hosts (`cpc_tpu_torch/parallel/multihost.py`) on the CPU:
"hosts" are launches whose LOCAL_WORLD_SIZE is below WORLD_SIZE, as
torchrun sets them on each host, with gloo ranks on one machine.

  * `local_layout`: a rank's place among its host's ranks, from every
    rank's hostname; the loopback test that keeps a coordinator at
    127.0.0.1 single-host; `initialize` under env:// without LOCAL_RANK
    deriving the layout after the rendezvous;
  * the training CLI under `--distributed` on 2 "hosts" of 1 rank (4 ranks
    on 2 hosts under the `slow` marker) against one process on the global
    batch: 'dp' (fp32 losses within 1e-7 relative, the port's DP bound) and
    'cp' across hosts (within 1e-5, the bound of `chip_smoke.py
    --cp-cards`: the ring sums in another order), each resumed in fresh
    processes bit for bit against its straight run.

One torch thread a process.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.parallel import multihost
from cpc_tpu_torch.parallel.multihost import _loopback, local_layout
from cpc_tpu_torch.train import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
TOL = {"dp": 1e-7, "cp": 1e-5}
TINY = {
    "dp": ["--config", "tpu_fast", "--batch-size", "4",
           "--snippet-samples", "1600",
           "--set", "model.encoder.channels=8,8,8,8,8",
           "--set", "model.encoder.d_enc=8", "--set", "model.ar.d_ar=8",
           "--set", "model.loss.prediction_steps=2",
           "--set", "model.dtype=float32",
           "--set", "model.loss.pallas_bf16=false"],
    "cp": ["--config", "transformer_gar", "--batch-size", "4",
           "--snippet-samples", "3200",
           "--set", "model.encoder.channels=8,8,8,8,8",
           "--set", "model.encoder.d_enc=8", "--set", "model.ar.d_ar=8",
           "--set", "model.ar.num_heads=2",
           "--set", "model.loss.prediction_steps=2",
           "--set", "model.loss.negatives=all_steps",
           "--set", "train.parallel=cp"]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- the layout
@pytest.mark.parametrize("hosts,rank,want", [
    (["a"], 0, (0, 1)),
    (["a", "a", "b", "b"], 0, (0, 2)),
    (["a", "a", "b", "b"], 3, (1, 2)),
    (["a", "b", "a", "b"], 2, (1, 2)),   # interleaved: rank order
    (["a", "b", "b", "b"], 0, (0, 1)),   # uneven hosts
    (["a", "b", "b", "b"], 3, (2, 3)),
])
def test_local_layout(hosts, rank, want):
    assert local_layout(hosts, rank) == want


@pytest.mark.parametrize("address,want", [
    ("127.0.0.1:29500", True), ("localhost:1", True), ("[::1]:7", True),
    ("127.1.2.3:9", True), ("10.0.0.2:29500", False),
    ("node-3:29500", False)])
def test_loopback_coordinator_is_one_host(address, want):
    assert _loopback(address) is want


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_env_launch_without_local_rank_derives_the_layout(monkeypatch):
    # a launcher that sets neither LOCAL_RANK nor LOCAL_WORLD_SIZE: the
    # layout comes from the hostnames, gathered after the rendezvous
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in (("WORLD_SIZE", "1"), ("RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(k, v)
    placed = []
    place = multihost._place
    monkeypatch.setattr(multihost, "_place",
                        lambda local, *a: placed.append(local)
                        or place(local, *a))
    mesh = multihost.initialize(device="cpu", timeout=60)
    try:
        assert placed == [(0, 1)]
        assert (mesh.rank, mesh.size, mesh.device) == (0, 1,
                                                       torch.device("cpu"))
    finally:
        multihost.shutdown()


# ------------------------------------------------------ through the CLI
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mh_corpus"))
    generate_synthetic_corpus(root, num_speakers=4, files_per_speaker=2,
                              seconds_per_file=1.0, seed=7)
    return root


def _argv(parallel, corpus, workdir, steps, *extra):
    return [*TINY[parallel], "--data", corpus, "--workdir", workdir,
            "--steps", str(steps), "--device", "cpu",
            "--set", "train.log_every=1", "--set", "train.checkpoint_every=2",
            *extra]


def hosts(parallel, corpus, workdir, steps, n_hosts, per_host, *extra,
          timeout=240.0):
    """The training CLI under --distributed on n_hosts x per_host gloo
    ranks, each launched with its host's LOCAL_RANK and LOCAL_WORLD_SIZE;
    returns each rank's stdout."""
    world, port = n_hosts * per_host, _free_port()
    cmd = [sys.executable, "-m", "cpc_tpu_torch.train", "--distributed",
           *_argv(parallel, corpus, workdir, steps, *extra)]
    base = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(per_host))
    logs = os.path.dirname(workdir)
    procs, files = [], []
    for r in range(world):
        out = open(os.path.join(logs, f"rank{r}.out"), "w+")
        err = open(os.path.join(logs, f"rank{r}.err"), "w+")
        files.append((out, err))
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, stdout=out, stderr=err, text=True,
            env=dict(base, RANK=str(r), LOCAL_RANK=str(r % per_host))))
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
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        texts.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    for r, (rc, out, err) in enumerate(texts):
        assert rc == 0, f"rank {r} exited {rc}\n{out}\n{err[-4000:]}"
    return [out for _, out, _ in texts]


def _losses(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["loss"] for r in recs if r["prefix"] == "train"}


@pytest.fixture(scope="module")
def one_process(corpus, tmp_path_factory):
    """Each mode's run in this process, on the global batch."""
    out = {}
    for parallel in TINY:
        wd = str(tmp_path_factory.mktemp(f"one_{parallel}") / "wd")
        assert cli.main(_argv(parallel, corpus, wd, STEPS)) == 0
        out[parallel] = _losses(wd)
    return out


def _held(workdir, want, tol):
    got = _losses(workdir)
    assert sorted(got) == sorted(want) == list(range(1, STEPS + 1))
    for step in want:
        np.testing.assert_allclose(got[step], want[step], rtol=tol,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("parallel", ["dp", "cp"])
def test_two_hosts_equal_one_process_and_resume(parallel, corpus,
                                                one_process, tmp_path):
    straight = str(tmp_path / "straight" / "wd")
    os.makedirs(os.path.dirname(straight))
    outs = hosts(parallel, corpus, straight, STEPS, 2, 1)
    assert "processes=2" in outs[0]
    _held(straight, one_process[parallel], TOL[parallel])
    resumed = str(tmp_path / "resumed" / "wd")
    os.makedirs(os.path.dirname(resumed))
    hosts(parallel, corpus, resumed, STEPS // 2, 2, 1)
    outs = hosts(parallel, corpus, resumed, STEPS, 2, 1, "--resume")
    assert f"resume: restored step {STEPS // 2}" in outs[0]
    assert _losses(resumed) == _losses(straight)
    a, b = (torch.load(os.path.join(w, "checkpoints", f"step_{STEPS}.pt"))
            for w in (straight, resumed))
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    assert a["meta"] == b["meta"]


@pytest.mark.slow
@pytest.mark.parametrize("parallel", ["dp", "cp"])
def test_two_hosts_of_two_ranks_equal_one_process(parallel, corpus,
                                                  one_process, tmp_path):
    wd = str(tmp_path / "run" / "wd")
    os.makedirs(os.path.dirname(wd))
    outs = hosts(parallel, corpus, wd, STEPS, 2, 2)
    assert "processes=4" in outs[0]
    _held(wd, one_process[parallel], TOL[parallel])
