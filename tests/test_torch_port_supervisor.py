"""The port's training supervisor (`cpc_tpu_torch/train/supervisor.py`):
tests/test_supervisor.py's stub cases against the port's `supervise` (crash
restarts, hang detection with SIGTERM then SIGKILL, the consecutive
no-progress budget, the CLI's dispatch), `latest_checkpoint_step` on the
port's `checkpoints/step_<n>.pt` layout, and the port's CLI under
`--supervise` SIGKILLed once its first checkpoint lands, resumed to the
parameters of a run that was never killed. The stub children are plain
Python started with -S, so the policy cases take seconds."""

import functools
import json
import os
import signal
import sys
import threading
import time

import pytest
import torch

from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.train import cli, supervisor
from cpc_tpu_torch.train.checkpoint import CheckpointManager
from cpc_tpu_torch.train.supervisor import (SupervisedRun,
                                            latest_checkpoint_step,
                                            strip_supervisor_flags,
                                            supervise)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one intra-op thread, as the supervised children get (OMP_NUM_THREADS):
    # the straight run's sums then go in the children's order
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# behaviors: ok | crash | hang (ignores SIGTERM) | pcrash (a new checkpoint
# in the port's layout, then a crash); the attempt count lives in the
# workdir, and the --resume a restart appends is ignored
_STUB = r"""
import os, signal, sys, time
wd = sys.argv[1]
behaviors = [a for a in sys.argv[2:] if a != "--resume"]
cf = os.path.join(wd, "invocations.txt")
n = int(open(cf).read()) if os.path.exists(cf) else 0
open(cf, "w").write(str(n + 1))
b = behaviors[min(n, len(behaviors) - 1)]
if b == "ok":
    open(os.path.join(wd, "metrics.jsonl"), "a").write('{"step": 999}\n')
    sys.exit(0)
if b == "crash":
    sys.exit(3)
if b == "hang":
    open(os.path.join(wd, "metrics.jsonl"), "a").write('{"step": 1}\n')
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    time.sleep(120)
    sys.exit(0)
if b == "pcrash":
    d = os.path.join(wd, "checkpoints")
    os.makedirs(d, exist_ok=True)
    open(os.path.join(d, f"step_{(n + 1) * 5}.pt"), "wb").close()
    sys.exit(3)
raise SystemExit(f"unknown behavior {b}")
"""


def _run(wd, behaviors, **kw):
    kw.setdefault("poll", 0.1)
    kw.setdefault("backoff", 0.05)
    kw.setdefault("term_grace", 1.0)
    kw.setdefault("log", lambda m: None)
    argv = [sys.executable, "-S", "-c", _STUB, wd, *behaviors]
    return supervise(argv, wd, **kw)


def test_crash_then_ok(tmp_path):
    wd = str(tmp_path)
    res = _run(wd, ["crash", "ok"], max_restarts=3)
    assert res.exit_code == 0 and res.restarts == 1
    assert any("exit code 3" in e for e in res.events)
    assert any("--resume" in e for e in res.events)
    assert os.path.exists(os.path.join(wd, "supervisor.log"))


def test_hang_detected_killed_resumed(tmp_path):
    t0 = time.time()
    res = _run(str(tmp_path), ["hang", "ok"], stale_after=1.0,
               max_restarts=2)
    assert res.exit_code == 0 and res.restarts == 1
    assert any("STALE" in e for e in res.events)
    assert any("SIGKILL" in e for e in res.events)
    assert time.time() - t0 < 30


def test_budget_spent_on_repeated_no_progress_crash(tmp_path):
    res = _run(str(tmp_path), ["crash"], max_restarts=2)
    assert res.exit_code == 3 and res.restarts == 2
    assert any("budget spent" in e for e in res.events)


def test_progress_resets_budget(tmp_path):
    # each attempt leaves a new step_<n>.pt before it crashes: the port's
    # layout counts as progress, so max_restarts=1 still reaches 'ok'
    wd = str(tmp_path)
    res = _run(wd, ["pcrash", "pcrash", "pcrash", "ok"], max_restarts=1)
    assert res.exit_code == 0 and res.restarts == 3
    assert latest_checkpoint_step(wd) == 15


def test_signal_death_exit_code_mapping(tmp_path):
    child = [sys.executable, "-S", "-c",
             "import os, signal; os.kill(os.getpid(), signal.SIGKILL)"]
    res = supervise(child, str(tmp_path), stale_after=60, max_restarts=0,
                    backoff=0.01, poll=0.05, log=lambda m: None)
    assert res.exit_code == 137  # 128 + SIGKILL


def test_latest_checkpoint_step_reads_the_ports_layout(tmp_path):
    wd = str(tmp_path)
    assert latest_checkpoint_step(wd) == -1
    d = tmp_path / "checkpoints"
    d.mkdir()
    for name in ("step_3.pt", "step_12.pt", "step_40.pt.123.tmp", "7",
                 "step_x.pt"):
        (d / name).write_bytes(b"")
    # a temporary file is not a checkpoint, nor is orbax's digit-named one
    assert latest_checkpoint_step(wd) == 12
    assert latest_checkpoint_step(wd) == \
        CheckpointManager(str(d)).steps()[-1]


def test_strip_supervisor_flags():
    argv = ["--config=tpu_fast", "--supervise", "--stale-after", "600",
            "--max-restarts=2", "--workdir", "w", "--stale-after=90"]
    assert strip_supervisor_flags(argv) == ["--config=tpu_fast", "--workdir",
                                            "w"]


def test_cli_dispatch(tmp_path, monkeypatch):
    """--supervise runs the same command, minus the supervisor's flags, as
    `python -m cpc_tpu_torch.train`, before any device is asked for (here
    --device cuda on a CPU machine); it refuses --distributed."""
    seen = {}

    def fake(child_argv, workdir, **kw):
        seen["argv"], seen["wd"], seen["kw"] = list(child_argv), workdir, kw
        return SupervisedRun(0, 0, [])

    monkeypatch.setattr(supervisor, "supervise", fake)
    argv = ["--config=tpu_fast", f"--workdir={tmp_path}", "--steps=1",
            "--device", "cuda", "--supervise", "--stale-after=77",
            "--max-restarts=1"]
    assert cli.main(argv) == 0
    assert seen["argv"] == [sys.executable, "-m", "cpc_tpu_torch.train",
                            "--config=tpu_fast", f"--workdir={tmp_path}",
                            "--steps=1", "--device", "cuda"]
    assert seen["wd"] == str(tmp_path)
    assert seen["kw"] == {"stale_after": 77.0, "max_restarts": 1}
    with pytest.raises(SystemExit):
        cli.main(argv + ["--distributed"])


TINY = ["--config", "tpu_fast", "--device", "cpu", "--batch-size", "4",
        "--snippet-samples", "2560",
        "--set", "model.encoder.channels=16,16,16,16,16",
        "--set", "model.encoder.d_enc=16", "--set", "model.ar.d_ar=16",
        "--set", "model.loss.prediction_steps=3",
        "--set", "train.checkpoint_every=5", "--set", "train.log_every=1",
        "--augment", "--device-corpus"]
STEPS = 30


def test_cli_sigkilled_under_supervise_resumes_exactly(tmp_path,
                                                      monkeypatch):
    """The port's CLI with --supervise on the CPU: its child is SIGKILLed
    once its first checkpoint lands, the supervisor restarts it with
    --resume, and the run ends at the parameters of a run never killed.
    The supervisor polls and backs off at 0.1 s here, not 10 s."""
    monkeypatch.setattr(supervisor, "supervise", functools.partial(
        supervisor.supervise, poll=0.1, backoff=0.1))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    corpus = str(tmp_path / "corpus")
    generate_synthetic_corpus(corpus, num_speakers=4, files_per_speaker=2,
                              seconds_per_file=0.4, seed=5)
    wd, straight = str(tmp_path / "run"), str(tmp_path / "straight")
    killed = {}

    def killer():
        deadline = time.time() + 120
        pid_path = os.path.join(wd, "supervisor_child.pid")
        while time.time() < deadline:
            if latest_checkpoint_step(wd) >= 5 and os.path.exists(pid_path):
                pid = int(open(pid_path).read())
                try:
                    os.kill(pid, signal.SIGKILL)
                    killed["pid"] = pid
                except ProcessLookupError:
                    pass
                return
            time.sleep(0.02)

    th = threading.Thread(target=killer, daemon=True)
    th.start()
    code = cli.main([*TINY, "--data", corpus, "--workdir", wd, "--steps",
                     str(STEPS), "--supervise", "--stale-after", "120",
                     "--max-restarts", "2"])
    th.join(timeout=10)
    assert not th.is_alive()
    assert code == 0 and "pid" in killed, killed
    with open(os.path.join(wd, "supervisor.log")) as f:
        log = f.read()
    assert "attempt 2" in log and "--resume" in log
    steps = [json.loads(line)["step"]
             for line in open(os.path.join(wd, "metrics.jsonl"))]
    assert max(steps) == STEPS and steps.count(1) == 1
    assert cli.main([*TINY, "--data", corpus, "--workdir", straight,
                     "--steps", str(STEPS)]) == 0
    a, b = (CheckpointManager(os.path.join(w, "checkpoints")).restore_latest()
            for w in (straight, wd))
    assert a["meta"] == b["meta"] and a["meta"]["step"] == STEPS
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
