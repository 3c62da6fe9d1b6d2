"""The port's trainer through its CLI (`cpc_tpu_torch.train.cli.main`, and
`python -m cpc_tpu_torch.train`) on the CPU at a tiny `--set` config:
metrics, checkpoints, exact resume (N steps straight equal k steps,
`--resume`, then N - k steps, parameter for parameter) and SIGTERM."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cpc_tpu_torch.train import cli
from cpc_tpu_torch.train.checkpoint import CheckpointManager
from cpc_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
TINY = ["--config", "tpu_fast", "--data", "synthetic", "--device", "cpu",
        "--batch-size", "4", "--snippet-samples", "2560",
        "--set", "model.encoder.channels=16,16,16,16,16",
        "--set", "model.encoder.d_enc=16", "--set", "model.ar.d_ar=16",
        "--set", "model.loss.prediction_steps=3",
        "--set", "train.checkpoint_every=2", "--set", "train.log_every=1",
        "--set", "train.eval_every=3"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny tensors: one intra-op thread, so that parallel test workers do
    # not oversubscribe the cores (measured 3x slower under load without)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(workdir, *extra):
    assert cli.main([*TINY, "--workdir", str(workdir), *extra]) == 0


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _final_model(workdir, step):
    path = os.path.join(workdir, "checkpoints", f"step_{step}.pt")
    return torch.load(path, weights_only=True)


def test_train_writes_metrics_config_and_checkpoints(tmp_path):
    _run(tmp_path, "--steps", "5", "--set", "train.keep_checkpoints=2")
    recs = _records(tmp_path)
    train = [r for r in recs if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3, 4, 5]
    assert [r["step"] for r in recs if r["prefix"] == "val"] == [3]
    for r in train:
        assert len(r["acc"]) == 3 and r["audio_sec_per_sec"] > 0
        assert all(map(lambda v: v == v, [r["loss"], r["grad_norm"]]))
    # every 2 steps and at the end, newest 2 kept
    assert CheckpointManager(str(tmp_path / "checkpoints")).steps() == [4, 5]
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg["name"] == "tpu_fast" and cfg["data"]["batch_size"] == 4


def test_resume_is_exact(tmp_path):
    straight, split = tmp_path / "straight", tmp_path / "split"
    _run(straight, "--steps", "4")
    _run(split, "--steps", "2")
    _run(split, "--steps", "4", "--resume")
    a, b = _final_model(straight, 4), _final_model(split, 4)
    assert a["meta"] == b["meta"]
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0)
    for moment in ("mu", "nu"):
        for k, v in a["optimizer"][moment].items():
            torch.testing.assert_close(b["optimizer"][moment][k], v, rtol=0,
                                       atol=0)
    assert [r["step"] for r in _records(split) if r["prefix"] == "train"] \
        == [1, 2, 3, 4]


def test_sigterm_checkpoints_and_stops(tmp_path, monkeypatch):
    real_init = Trainer.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        step = self.steps.train_step

        def preempting(batch):
            out = step(batch)
            if self.step == 2:  # the step being run is the third
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        self.steps = self.steps._replace(train_step=preempting)
    monkeypatch.setattr(Trainer, "__init__", init)
    _run(tmp_path, "--steps", "10")
    recs = _records(tmp_path)
    assert recs[-1]["step"] == 3 and recs[-1]["preempted"] == 1.0
    assert CheckpointManager(str(tmp_path / "checkpoints")).steps()[-1] == 3


def test_module_entry_point(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "cpc_tpu_torch.train", *TINY, "--steps", "1",
         "--workdir", str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "config=tpu_fast device=cpu" in proc.stdout
    assert _records(tmp_path)[-1]["step"] == 1


def test_cuda_device_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--workdir", str(tmp_path), "--steps", "1"])
