"""The program's host spans (`cpc_tpu_torch/utils/profiling.py`) on the CPU:
off, `span` is one shared object that never reads the clock; on, each
closed span is kept with its name, times and thread, and one left open when
recording stops is dropped; a tiny `Trainer.train` records, step by step
and in order, the trainer's phases around the step's, with `step.gather`
under a device corpus and `trainer.agree` and `step.average` under a
two-process gloo mesh; the train CLI's `--profile` writes them into its
Chrome trace, on the trace's own clock; and recording changes no bit of
the steps."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.data.dataset import SnippetDataset
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.train import cli
from cpc_tpu_torch.train.train_step import init_state, make_step_fns
from cpc_tpu_torch.train.trainer import Trainer
from cpc_tpu_torch.utils import profiling
from cpc_tpu_torch.utils.profiling import record_spans, span, take_spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SETS = ["model.encoder.channels=16,16,16,16,16", "model.encoder.d_enc=16",
             "model.ar.d_ar=16", "model.loss.prediction_steps=3",
             "data.batch_size=4", "data.snippet_samples=2560"]
STEP = ["trainer.feed", "trainer.stage", "trainer.step", "step.forward",
        "step.backward", "step.optimizer", "step.scalars"]


@pytest.fixture(autouse=True)
def _one_thread_and_no_recording():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if profiling._spans is not None:  # a failed test's recording
        take_spans()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    generate_synthetic_corpus(root, num_speakers=4, files_per_speaker=2,
                              seconds_per_file=0.4, seed=3)
    return root


def _cfg(*sets, preset="tpu_fast"):
    return tcfg.apply_overrides(getattr(tcfg.presets, preset)(),
                                [*TINY_SETS, *sets])


def _no_clock():
    raise AssertionError("the clock was read")


def _tree(spans):
    """(name, enclosing span's name or None) of each span, in order."""
    out, stack = [], []
    for a, b, name, _ in spans:
        while stack and stack[-1][1] <= a:
            stack.pop()
        assert not stack or b <= stack[-1][1], (name, stack[-1])
        out.append((name, stack[-1][2] if stack else None))
        stack.append((a, b, name))
    return out


def test_off_is_one_object_that_reads_no_clock(monkeypatch):
    cfg = _cfg()
    steps = make_step_fns(cfg, init_state(cfg, "cpu"))
    batch = torch.zeros((4, 2560), dtype=torch.int16)
    monkeypatch.setattr(time, "time_ns", _no_clock)
    assert span("a") is span("b") is profiling._OFF
    with span("a") as s:
        assert s is profiling._OFF
    steps.train_step(batch)  # every span of the step is the no-op
    with pytest.raises(ValueError):
        with span("a"):
            raise ValueError("passes through")


def test_recording_changes_no_bit_of_the_steps():
    cfg = _cfg("train.accum_steps=2", "data.augment=true")
    batches = torch.from_numpy(np.random.default_rng(0).integers(
        -6000, 6000, (2, 4, 2560), dtype=np.int16))
    runs = []
    for on in (False, True):
        model = init_state(cfg, "cpu")
        steps = make_step_fns(cfg, model)
        if on:
            record_spans()
        metrics = [steps.train_step(b) for b in batches]
        if on:
            assert len(take_spans()) == 2 * (2 * 2 + 2)
        runs.append((model, metrics))
    (a, ma), (b, mb) = runs
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in x)
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), k


def test_names_nesting_and_threads_when_on():
    def worker():
        with span("worker"):
            pass
    record_spans()
    with span("outer"):
        with span("inner"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        with pytest.raises(KeyError):
            with span("raised"):
                raise KeyError("a span closes as its exception leaves")
    got = take_spans()
    assert not t.is_alive()
    assert [s[2] for s in got] == ["outer", "inner", "worker", "raised"]
    assert all(isinstance(s[0], int) and s[0] <= s[1] for s in got)
    main = threading.get_native_id()
    assert [s[3] == main for s in got] == [True, True, False, True]
    assert _tree([s for s in got if s[3] == main]) == [
        ("outer", None), ("inner", "outer"), ("raised", "outer")]
    outer = got[0]
    assert all(outer[0] <= s[0] and s[1] <= outer[1] for s in got[1:])


def test_a_span_open_when_recording_stops_is_dropped():
    before = span("opened while off")  # the no-op: never kept
    before.__enter__()
    record_spans()
    with pytest.raises(RuntimeError, match="already"):
        record_spans()
    before.__exit__(None, None, None)
    left_open = span("left open")
    left_open.__enter__()
    with span("closed"):
        pass
    assert [s[2] for s in take_spans()] == ["closed"]
    record_spans()  # a later recording does not take it either
    left_open.__exit__(None, None, None)
    assert take_spans() == []
    with pytest.raises(RuntimeError, match="not being recorded"):
        take_spans()


@pytest.mark.parametrize("device_corpus", [False, True])
def test_trainer_records_each_step_in_order(corpus, tmp_path, device_corpus):
    cfg = _cfg("train.log_every=2", "train.eval_every=2",
               "train.checkpoint_every=2",
               f"data.device_corpus={str(device_corpus).lower()}")
    ds = SnippetDataset(corpus, 2560, device="cpu")
    tr = Trainer(cfg, ds, ds, workdir=str(tmp_path), device="cpu")
    try:
        tr.train(1)  # not recorded
        record_spans()
        tr.train(3)
        got = take_spans()
    finally:
        tr.close()
    step = [(n, "trainer.step" if n.startswith("step.") else None)
            for n in STEP]
    step[-1] = ("step.scalars", "step.optimizer")
    if device_corpus:
        step.insert(3, ("step.gather", "trainer.step"))
    want = [*step, ("trainer.log", None), ("trainer.validate", None),
            ("trainer.checkpoint", None), *step, ("trainer.log", None),
            ("trainer.checkpoint", None)]
    assert _tree(got) == want
    assert {s[3] for s in got} == {threading.get_native_id()}


RANK = """
import json, sys
import torch
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.data.dataset import SnippetDataset
from cpc_tpu_torch.parallel import multihost
from cpc_tpu_torch.train.trainer import Trainer
from cpc_tpu_torch.utils.profiling import record_spans, take_spans
torch.set_num_threads(1)
corpus, port, rank, sets = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
    sys.argv[4:]
mesh = multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu",
                            timeout=120)
cfg = tcfg.apply_overrides(tcfg.presets.dp_global_negatives(), sets)
tr = Trainer(cfg, SnippetDataset(corpus, 2560, device="cpu"), device="cpu",
             mesh=mesh)
record_spans()
tr.train(2)
print(json.dumps(take_spans()))
tr.close()
multihost.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_record_the_average_and_the_agreement(corpus):
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, corpus, port, str(r), *TINY_SETS,
         "train.log_every=100", "data.device_corpus=true"], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    step = [("trainer.feed", None), ("trainer.stage", None),
            ("trainer.step", None), ("step.gather", "trainer.step"),
            ("step.forward", "trainer.step"),
            ("step.backward", "trainer.step"),
            ("step.average", "trainer.step"),
            ("step.optimizer", "trainer.step"),
            ("step.scalars", "step.optimizer")]
    for spans in outs:
        assert _tree(spans) == [*step, ("trainer.agree", None), *step,
                                ("trainer.log", None),
                                ("trainer.agree", None)]


def test_profile_trace_holds_the_spans_on_its_clock(corpus, tmp_path):
    assert cli.main(["--config", "tpu_fast", "--device", "cpu",
                     "--batch-size", "4", "--snippet-samples", "2560",
                     *[a for s in TINY_SETS[:4] for a in ("--set", s)],
                     "--data", corpus, "--workdir", str(tmp_path),
                     "--steps", "2", "--profile"]) == 0
    assert profiling._spans is None  # the region stopped the recording
    with open(tmp_path / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == profiling.SPAN_CATEGORY]
    names = [e["name"] for e in mine]
    for name in STEP:
        assert names.count(name) == 2, name
    assert names.count("trainer.checkpoint") == 1
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in mine)
    # the profiler's own operators of the forward fall inside the span
    forward = [(e["ts"], e["ts"] + e["dur"]) for e in mine
               if e["name"] == "step.forward"]
    convs = [e["ts"] for e in events if e.get("cat") == "cpu_op"
             and e.get("name") == "aten::conv1d"]
    assert convs and all(any(a <= t <= b for a, b in forward)
                         for t in convs)
