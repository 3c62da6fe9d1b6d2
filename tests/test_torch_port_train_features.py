"""The trainer's data feed and side features on the CPU, at a tiny
`tpu_fast`: the device-resident corpus step against the host step (bit
for bit, also with accum_steps=2, under a one-rank gloo mesh and through
the Trainer), on-device augmentation (by distribution on a seeded
generator, its order against numpy given the same draws, the dropout
stream untouched by it), a `--packed --augment --device-corpus` CLI run
resumed bit for bit, TensorBoard's own reader on the event file,
`--nan-debug`, `--profile`, and the CLI's options against the JAX CLI's.

The augmentation's draws come from `torch.Generator`, so they cannot equal
`jax.random`'s: its ranges and rates are held by distribution (4 096 rows:
a polarity rate within 0.5 +- 0.03 is more than 3 standard deviations),
its order exactly."""

import ast
import dataclasses
import json
import os
import pathlib
import socket
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cpc_tpu.train.cli import build_argparser as jax_build_argparser
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.data.dataset import SnippetDataset
from cpc_tpu_torch.data.packed import pack_corpus
from cpc_tpu_torch.data.synthetic import generate_synthetic_corpus
from cpc_tpu_torch.ops import dsp
from cpc_tpu_torch.parallel import multihost
from cpc_tpu_torch.parallel.mesh import ProcessMesh
from cpc_tpu_torch.train import cli, train_step
from cpc_tpu_torch.train.checkpoint import CheckpointManager
from cpc_tpu_torch.train.train_step import (augment_generator,
                                            dropout_generator, init_state,
                                            make_step_fns)
from cpc_tpu_torch.train.trainer import Trainer
from cpc_tpu_torch.utils.profiling import enable_nan_debug

TINY_SETS = ["model.encoder.channels=16,16,16,16,16", "model.encoder.d_enc=16",
             "model.ar.d_ar=16", "model.loss.prediction_steps=3",
             "data.batch_size=4", "data.snippet_samples=2560"]
TINY = ["--config", "tpu_fast", "--device", "cpu", "--batch-size", "4",
        "--snippet-samples", "2560",
        *[a for s in TINY_SETS[:4] for a in ("--set", s)],
        "--set", "train.log_every=1", "--set", "train.checkpoint_every=2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(*sets, preset="tpu_fast"):
    return tcfg.apply_overrides(getattr(tcfg.presets, preset)(),
                                [*TINY_SETS, *sets])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    generate_synthetic_corpus(root, num_speakers=4, files_per_speaker=2,
                              seconds_per_file=0.4, seed=3)
    return root


def _corpus_tensor(n=12, S=2560, seed=5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.clip(rng.standard_normal((n, S)) * 4000,
                                    -32768, 32767).astype(np.int16))


def _assert_same(models, metrics):
    (m0, m1), (a, b) = metrics, models
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p.grad, q.grad), f"grad {k}"
        assert torch.equal(p, q), f"param {k}"


def _pair(cfg, mesh=None):
    """Two models from one seed: the host step's and the device corpus
    step's."""
    host = init_state(cfg, "cpu")
    dc_cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, device_corpus=True))
    dc = init_state(dc_cfg, "cpu")
    return (host, make_step_fns(cfg, host)), (dc, make_step_fns(dc_cfg, dc,
                                                                mesh))


@pytest.mark.parametrize("accum", [1, 2])
def test_device_corpus_step_is_bit_equal_to_host_step(accum):
    cfg = _cfg(f"train.accum_steps={accum}", "data.augment=true")
    (host, hs), (dc, ds) = _pair(cfg)
    corpus = _corpus_tensor()
    for idx in ([7, 0, 11, 3], [1, 2, 9, 4]):
        idx = torch.tensor(idx, dtype=torch.int32)
        metrics = (hs.train_step(corpus[idx.long()]),
                   ds.train_step(corpus, idx))
        _assert_same((host, dc), metrics)
    m = hs.eval_step(corpus[:4]), ds.eval_step(corpus, torch.arange(4))
    assert all(torch.equal(m[0][k], m[1][k]) for k in m[0])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_device_corpus_step_under_one_rank_mesh():
    cfg = _cfg("model.loss.cross_replica=true")
    mesh = multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                                device="cpu", timeout=60)
    try:
        (host, hs), (dc, ds) = _pair(cfg, mesh)
        corpus = _corpus_tensor()
        idx = np.array([5, 1, 10, 2], np.int32)
        rows = torch.from_numpy(multihost.shard_batch(idx, mesh))
        metrics = hs.train_step(corpus[idx]), ds.train_step(corpus, rows)
        _assert_same((host, dc), metrics)
    finally:
        multihost.shutdown()


class _Ranks:
    """Threads that play the ranks of a gloo group: all_reduce sums every
    rank's buffer in rank order (as tests/test_torch_port_dp.py does)."""

    def __init__(self, world):
        self.bufs = [None] * world
        self.barrier = threading.Barrier(world, timeout=60)

    def all_reduce(self, t, op=None, group=None):
        self.bufs[group] = t.clone()
        self.barrier.wait()
        total = self.bufs[0].clone()
        for b in self.bufs[1:]:
            total += b
        self.barrier.wait()
        t.copy_(total)

    def run(self, fn):
        out, errors = [None] * len(self.bufs), []

        def one(r):
            try:
                out[r] = fn(ProcessMesh(rank=r, size=len(self.bufs),
                                        device=torch.device("cpu"), group=r))
            except BaseException as e:  # reported below, with the rank
                errors.append((r, e))
                self.barrier.abort()
        threads = [threading.Thread(target=one, args=(r,))
                   for r in range(len(self.bufs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        return out


def test_device_corpus_rows_equal_the_host_rows_on_two_ranks(monkeypatch):
    """Two ranks (threads) with cross-replica negatives and augmentation:
    each gathers its share of the index vector from its own copy of the
    corpus, and its step equals its step on its rows of the host batch,
    metrics, gradients and parameters bit for bit."""
    cfg = _cfg("model.loss.cross_replica=true", "data.augment=true")
    ranks = _Ranks(2)
    monkeypatch.setattr(dist, "all_reduce", ranks.all_reduce)
    corpus = _corpus_tensor()
    idx = np.array([9, 2, 4, 11], np.int32)
    host_batch = corpus.numpy()[idx]

    def step(device_corpus):
        def rank(mesh):
            c = dataclasses.replace(cfg, data=dataclasses.replace(
                cfg.data, device_corpus=device_corpus))
            model = init_state(c, "cpu")
            fns = make_step_fns(c, model, mesh)
            if device_corpus:
                rows = torch.from_numpy(multihost.shard_batch(idx, mesh))
                m = fns.train_step(corpus.clone(), rows)
            else:
                m = fns.train_step(torch.from_numpy(
                    multihost.shard_batch(host_batch, mesh)))
            return model, m
        return ranks.run(rank)
    for (hm, hmet), (dm, dmet) in zip(step(False), step(True)):
        _assert_same((hm, dm), (hmet, dmet))


def test_trainer_device_corpus_equals_host_trainer(corpus, tmp_path):
    cfg = _cfg("train.eval_every=2", "train.log_every=1",
               "train.checkpoint_every=100", "data.augment=true")
    runs = []
    for dc in (False, True):
        c = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, device_corpus=dc))
        ds = SnippetDataset(corpus, 2560, device="cpu")
        val = SnippetDataset(corpus, 2560, device="cpu")
        tr = Trainer(c, ds, val, workdir=str(tmp_path / str(dc)),
                     device="cpu")
        assert (tr._corpus is not None) == dc
        if dc:
            assert tr._val_corpus is tr._corpus  # the same snippets
        last = tr.train(3)
        runs.append((tr, last, tr.validate()))
        tr.close()
    (a, la, va), (b, lb, vb) = runs
    for k in ("loss", "acc", "grad_norm"):
        assert torch.equal(la[k], lb[k]), k
    assert all(torch.equal(va[k], vb[k]) for k in va)
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k


# ------------------------------------------------------------ augmentation
ROWS, S = 4096, 512


def _aug(x, **kw):
    gen = torch.Generator().manual_seed(11)
    opts = dict(gain_db=0.0, noise_snr_db=100.0, shift_max=0,
                polarity=False)
    opts.update(kw)
    return dsp.augment_waveform(x, gen, **opts).double().numpy()


def test_augment_gain_range():
    out = _aug(torch.ones(ROWS, S), gain_db=6.0)
    db = 20 * np.log10(out[:, 0])
    assert np.all(out == out[:, :1]) and np.all(np.abs(db) <= 6.0 + 1e-5)
    assert db.min() < -5.9 and db.max() > 5.9 and abs(db.mean()) < 0.2


def test_augment_polarity_rate():
    out = _aug(torch.ones(ROWS, S), polarity=True)
    assert set(np.unique(out)) == {-1.0, 1.0}
    assert abs((out[:, 0] < 0).mean() - 0.5) <= 0.03


def test_augment_shift_recovered_from_a_ramp():
    ramp = torch.arange(S, dtype=torch.float32).expand(ROWS, S)
    out = _aug(ramp, shift_max=160)
    shift = out[:, 0].astype(np.int64)
    shift = np.where(shift > S // 2, shift - S, shift)
    np.testing.assert_array_equal(out, (np.arange(S)[None, :]
                                        + shift[:, None]) % S)
    assert np.abs(shift).max() == 160 and set(shift) == set(range(-160, 161))


def test_augment_snr_range():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (ROWS, S)).astype(np.float32))
    out = _aug(x, noise_snr_db=30.0)
    clean = x.double().numpy()
    snr = 10 * np.log10((clean ** 2).mean(1)
                        / ((out - clean) ** 2).mean(1))
    # a noise power measured over 512 samples: +-0.6 dB at 4 sigma
    assert snr.min() > 30.0 - 0.6 and snr.max() < 50.0 + 0.6
    assert np.percentile(snr, 5) < 32 and np.percentile(snr, 95) > 48


def _numpy_augment(x, d):
    """The JAX order, in float64 numpy: gain, polarity, shift, noise at the
    shifted signal's power."""
    x = x * d.gain.double().numpy() * d.sign.double().numpy()
    idx = (np.arange(x.shape[1])[None, :] + d.shift.numpy()[:, None]) \
        % x.shape[1]
    x = np.take_along_axis(x, idx, axis=1)
    power = (x ** 2).mean(1, keepdims=True)
    return x + d.noise.double().numpy() * np.sqrt(power
                                                 / d.snr.double().numpy())


def test_augment_order_matches_numpy_given_the_draws():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, 300)).astype(np.float32))
    d = dsp.augment_draws(x.shape, torch.Generator().manual_seed(2),
                          shift_max=40)
    got = dsp.apply_augment(x, d).double().numpy()
    want = _numpy_augment(x.double().numpy(), d)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.array_equal(got, dsp.augment_waveform(
        x, torch.Generator().manual_seed(2), shift_max=40).double().numpy())
    # the order matters: noise scaled before the gain is another signal
    other = x.double().numpy()
    other = other + d.noise.double().numpy() * np.sqrt(
        (other ** 2).mean(1, keepdims=True) / d.snr.double().numpy())
    assert np.abs(_numpy_augment(other, d._replace(
        noise=torch.zeros_like(d.noise))) - want).max() > 1e-3


def test_augmentation_leaves_the_dropout_draws_alone(monkeypatch):
    sets = ["model.ar.d_ar=32", "model.ar.num_heads=4",
            "model.ar.dropout=0.2", "model.dtype=float32"]
    base = _cfg(*sets, preset="transformer_gar")
    on = dataclasses.replace(base, data=dataclasses.replace(
        base.data, augment=True))
    batch = _corpus_tensor(n=4)

    def step(cfg):
        model = init_state(cfg, "cpu")
        m = make_step_fns(cfg, model).train_step(batch)
        return m, model
    off_m, off = step(base)
    # augmentation on, its effect taken out: the step, dropout and all,
    # is the step without it
    monkeypatch.setattr(train_step, "augment_waveform", lambda x, g, **k: x)
    same_m, same = step(on)
    _assert_same((off, same), (off_m, same_m))
    monkeypatch.undo()
    aug_m, _ = step(on)
    assert not torch.equal(aug_m["loss"], off_m["loss"])
    for count in range(3):
        for mb in range(2):
            for rank in range(2):
                a = augment_generator(0, count, mb, "cpu", rank)
                b = dropout_generator(0, count, mb, "cpu", rank)
                assert a.initial_seed() != b.initial_seed()


# ------------------------------------------------------------ through the CLI
def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_augment_device_corpus_cli_resumes_bit_for_bit(corpus, tmp_path):
    # on a packed corpus: --packed --augment --device-corpus
    straight, split = str(tmp_path / "a"), str(tmp_path / "b")
    packed = str(tmp_path / "packed")
    pack_corpus(corpus, packed, device="cpu")
    feed = ["--data", packed, "--packed", "--augment", "--device-corpus"]
    assert cli.main([*TINY, *feed, "--workdir", straight, "--steps",
                     "8"]) == 0
    assert cli.main([*TINY, *feed, "--workdir", split, "--steps", "4"]) == 0
    assert cli.main([*TINY, *feed, "--workdir", split, "--steps", "8",
                     "--resume"]) == 0
    a, b = (CheckpointManager(os.path.join(w, "checkpoints")).restore_latest()
            for w in (straight, split))
    assert a["meta"] == b["meta"] and a["meta"]["step"] == 8
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    losses = [{r["step"]: r["loss"] for r in _records(w)
               if r["prefix"] == "train"} for w in (straight, split)]
    assert losses[0] == losses[1] and sorted(losses[0]) == list(range(1, 9))
    cfg = json.loads(open(os.path.join(straight, "config.json")).read())
    assert cfg["data"]["augment"] and cfg["data"]["device_corpus"]

    # the TensorBoard event file, through TensorBoard's own reader
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    ea = EventAccumulator(os.path.join(straight, "tb"))
    ea.Reload()
    recs = [r for r in _records(straight) if r["prefix"] == "train"]
    want = {"train/loss", "train/acc_mean", "train/grad_norm",
            "train/audio_sec_per_sec", "train/steps_per_sec",
            *(f"train/acc_{k}" for k in (1, 2, 3))}
    assert set(ea.Tags()["scalars"]) == want
    for tag in want:
        key = tag.split("/")[1]
        events = ea.Scalars(tag)
        assert [e.step for e in events] == [r["step"] for r in recs]
        for e, r in zip(events, recs):
            v = (r["acc"][int(key.split("_")[1]) - 1]
                 if key.startswith("acc_") and key != "acc_mean" else r[key])
            assert e.value == np.float32(v), (tag, e.value, v)


def test_nan_debug_raises_on_an_injected_nan(corpus, tmp_path):
    cfg = _cfg("train.checkpoint_every=100")
    tr = Trainer(cfg, SnippetDataset(corpus, 2560), device="cpu")
    try:
        tr.train(1)
        with torch.no_grad():
            tr.model.prediction_heads.weight[0, 0] = float("nan")
        enable_nan_debug()
        with pytest.raises(FloatingPointError,
                           match="loss at step 2, in the forward"):
            tr.train(2)
    finally:
        enable_nan_debug(False)
        tr.close()
    assert not torch.is_anomaly_enabled()
    # a NaN that first appears in a backward function
    class NanGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * float("nan")
    x = torch.ones(3, requires_grad=True)
    with torch.autograd.set_detect_anomaly(True):
        with pytest.raises(FloatingPointError,
                           match="step 7, in the backward"):
            train_step._checked_backward(NanGrad.apply(x).sum(), 7)
    # through the CLI: a NaN learning rate makes step 2's loss NaN
    with pytest.raises(FloatingPointError, match="step 2, in the forward"):
        cli.main([*TINY, "--data", corpus, "--workdir", str(tmp_path / "n"),
                  "--steps", "3", "--nan-debug", "--set",
                  "train.learning_rate=nan"])
    assert not torch.is_anomaly_enabled()
    assert cli.main([*TINY, "--data", corpus, "--workdir",
                     str(tmp_path / "ok"), "--steps", "2",
                     "--nan-debug"]) == 0


def test_profile_leaves_a_trace(corpus, tmp_path):
    assert cli.main([*TINY, "--data", corpus, "--workdir", str(tmp_path),
                     "--steps", "2", "--profile"]) == 0
    with open(tmp_path / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_cli_has_every_option_of_the_jax_cli():
    def options(parser):
        return {(s, a.dest, repr(a.default)) for a in parser._actions
                for s in a.option_strings}
    ours, theirs = options(cli.build_argparser()), options(
        jax_build_argparser())
    missing = {s for s, _, _ in theirs} - {s for s, _, _ in ours}
    assert not missing, missing
    # the eight flags of this slice: JAX's dests and defaults
    for flag in ("--packed", "--augment", "--device-corpus", "--supervise",
                 "--stale-after", "--max-restarts", "--profile",
                 "--nan-debug"):
        assert {(d, v) for s, d, v in ours if s == flag} == \
            {(d, v) for s, d, v in theirs if s == flag}, flag
    with pytest.raises(SystemExit):
        cli.build_argparser().parse_args(["--superv"])


def test_cli_trains_under_torch_default_cudnn_settings(corpus, tmp_path,
                                                        monkeypatch):
    """Exact resume and the supervisor's restart were checked bit for bit on
    the card under torch's default cuDNN settings, deterministic and
    benchmark off (chip_smoke.py phases 23(d), 24(d), 24(g)), and rest on
    them: no module of the port sets either, or asks for deterministic
    algorithms (but `utils/precision.py::cudnn_deterministic`, through
    setattr, inside the backward of the fp32 convs whose default sums with
    atomics: ROADMAP C16, test_repeatable_conv_backward), and the CLI, and
    so the supervisor's child, which is the same CLI, trains under them.
    benchmark=True would pick each conv's algorithm by timing, so two runs
    could sum in different orders."""
    root = pathlib.Path(cli.__file__).resolve().parents[1]
    found = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            targets = (node.targets if isinstance(node, ast.Assign) else
                       [node.target] if isinstance(
                           node, (ast.AugAssign, ast.AnnAssign)) else [])
            names = [t.attr for t in targets if isinstance(t, ast.Attribute)
                     and t.attr in ("benchmark", "deterministic")]
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr in (
                        "use_deterministic_algorithms", "flags"):
                names.append(node.func.attr)
            found += [f"{path.relative_to(root)}:{node.lineno} {n}"
                      for n in names]
    assert found == []
    seen = []
    train = Trainer.train

    def spy(self, *args, **kwargs):
        seen.append((torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark))
        return train(self, *args, **kwargs)
    monkeypatch.setattr(Trainer, "train", spy)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    assert cli.main([*TINY, "--data", corpus, "--workdir", str(tmp_path),
                     "--steps", "1"]) == 0
    assert seen == [(False, False)]


# -------------------------------------------------------------------- C15
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp32_models_compute_without_tf32(dtype, monkeypatch):
    """ROADMAP C15: an fp32 model's training step (forward, backward and
    update), evaluation step, offline extraction and the probes'
    extraction run their convs with cuDNN's and cuBLAS's TF32 off,
    whatever the caller's settings; a bf16 model runs under the caller's;
    cuDNN's `deterministic` stays the caller's in either (C16 is repaired
    in the backward of the convs at fault, test_repeatable_conv_backward);
    and outside
    each call the flags read as the caller left them. Recorded on the CPU
    by wrapping F.conv1d (the forward) and a hook on the first conv's
    weight gradient (the backward)."""
    from cpc_tpu_torch.eval import probes
    from cpc_tpu_torch.eval.features import extract_features

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.deterministic)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    seen = {"forward": [], "backward": []}
    conv = torch.nn.functional.conv1d

    def spy(*args, **kwargs):
        seen["forward"].append(flags())
        return conv(*args, **kwargs)
    monkeypatch.setattr(torch.nn.functional, "conv1d", spy)
    cfg = tcfg.apply_overrides(tcfg.presets.by_name("tpu_fast"),
                               TINY_SETS + [f"model.dtype={dtype}"])
    model = init_state(cfg)
    model.encoder.conv0.weight.register_hook(
        lambda g: seen["backward"].append(flags()))
    steps = make_step_fns(cfg, model)
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        -3000, 3000, (4, 2560)).astype(np.int16))
    steps.train_step(batch)
    assert flags() == (True, True, False)
    steps.eval_step(batch)
    wave = np.random.default_rng(1).standard_normal(5120).astype(np.float32)
    extract_features(model, wave, window=2560, batch_windows=2)
    probes._extract(model, batch.numpy(), "c", batch=4)
    assert flags() == (True, True, False)
    want = ((False, False, False) if dtype == "float32"
            else (True, True, False))
    assert len(seen["forward"]) == 4 * 5 and len(seen["backward"]) == 1
    assert set(seen["forward"]) == set(seen["backward"]) == {want}


@pytest.mark.parametrize("kernel,stride,needs_input", [
    ((10,), 5, False), ((4,), 2, True), ((3,), 1, True),
    ((3, 3), (1, 1), False), ((4, 2), (2, 1), True)])
def test_repeatable_conv_backward(kernel, stride, needs_input, monkeypatch):
    """ROADMAP C16: the route of the fp32 convs whose cuDNN backward sums
    with atomics (`conv_cuda._Repeatable`, conv1d and conv2d) against
    autograd through F.conv1d / F.conv2d, on the CPU: the same forward,
    the same gradients, computed with cuDNN's `deterministic` on and the
    caller's flag back after."""
    from cpc_tpu_torch.ops.conv_cuda import _Repeatable
    rng = np.random.default_rng(len(kernel) * 10 + kernel[0])
    size = (203,) if len(kernel) == 1 else (37, 21)
    conv = (torch.nn.functional.conv1d if len(kernel) == 1
            else torch.nn.functional.conv2d)
    x = torch.from_numpy(rng.standard_normal((3, 2, *size))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 2, *kernel))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    got = [t.clone().requires_grad_(r) for t, r in
           ((x, needs_input), (w, True), (b, True))]
    want = [t.clone().requires_grad_(r) for t, r in
            ((x, needs_input), (w, True), (b, True))]
    seen = []
    name = f"conv{len(kernel)}d_weight"
    real = getattr(torch.nn.grad, name)

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.deterministic)
        return real(*args, **kwargs)
    monkeypatch.setattr(torch.nn.grad, name, spy)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    out = _Repeatable.apply(*got, stride)
    ref = conv(*want, stride=stride)
    assert torch.equal(out, ref)
    g = torch.from_numpy(rng.standard_normal(ref.shape).astype(np.float32))
    out.backward(g)
    ref.backward(g)
    assert seen == [True] and not torch.backends.cudnn.deterministic
    for a, r in zip(got, want):
        assert (a.grad is None) == (r.grad is None) == (not a.requires_grad)
        if a.grad is not None:
            torch.testing.assert_close(a.grad, r.grad, rtol=1e-5, atol=1e-5)
