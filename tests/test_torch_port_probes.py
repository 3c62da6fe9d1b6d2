"""The port's probes, battery and probe CLI (cpc_tpu_torch/eval/probes.py,
battery.py, cli.py, data/dataset.py::ProbeDataset) against the JAX
package's, on the CPU in fp32, JAX at 'highest' matmul precision, on the
tiny model of tests/test_probes.py and its synthetic corpus.

* Exact: ProbeDataset's speaker ids and labelled items (short or missing
  phone labels give None in both), `_split`, `_split_items`, `pool_time`,
  the frames' majority phone labels.
* `_extract` and the frame features within 1e-5 of JAX's (weights through
  `from_jax_params`).
* The fit: started from JAX's own w0 (`probes.py:72-73`, computed here),
  `_fit_linear` lands within 1e-5 of an optax Adam loop on the same loss
  after 50 steps, with the same eval predictions.
* `_train_linear` end to end draws its w0 from a torch.Generator, which
  cannot equal jax.random's draw, so the two agree on accuracy within a
  band, over 3 seeds on the same features: at most max(2 eval items, 1 %)
  apart. Measured here: 0 on the speaker probe (18 eval items), at most 1
  of 2 000 eval frames on the phone probe. It cannot be tighter than an item
  or two: another w0 leaves another weight after 300 steps of an
  unregularized fit, and items near the boundary flip.
* The battery hands its probes what JAX's hands them: with both packages'
  `_train_linear` replaced by one stand-in, the two rows are equal.
* The CLI (`--battery`, `--probe`) on a workdir the port's training CLI
  wrote and on one holding the JAX package's jax_params.npz; the battery
  gives the same row twice.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpc_tpu import config as jcfg
from cpc_tpu.data.dataset import ProbeDataset as JaxProbeDataset
from cpc_tpu.data.synthetic import generate_synthetic_corpus
from cpc_tpu.eval import battery as jbattery
from cpc_tpu.eval import probes as jp
from cpc_tpu.models.cpc import CPCModel as JaxCPCModel
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.data.dataset import ProbeDataset
from cpc_tpu_torch.eval import battery
from cpc_tpu_torch.eval import cli as eval_cli
from cpc_tpu_torch.eval import probes as tp
from cpc_tpu_torch.interop import flatten_params, from_jax_params
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.train import cli as train_cli

SNIPPET = 8000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors: one intra-op thread, so that parallel test workers do
    # not oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, both datasets, the JAX model and params, the port's
    model on the same weights, and JAX's features of both probes."""
    root = str(tmp_path_factory.mktemp("probe_corpus"))
    generate_synthetic_corpus(root, num_speakers=4, files_per_speaker=3,
                              seconds_per_file=3.0, seed=11)
    jmc = jcfg.ModelConfig(
        encoder=jcfg.EncoderConfig(channels=(32, 32, 64), kernels=(10, 8, 4),
                                   strides=(5, 4, 2), d_enc=64),
        ar=jcfg.ArConfig(d_ar=32),
        loss=jcfg.LossConfig(prediction_steps=4))
    jmodel = JaxCPCModel(jmc)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  np.zeros((2, SNIPPET), np.float32))
    tc = tcfg.from_dict(jcfg.to_dict(jcfg.CPCConfig(model=jmc)))
    model = CPCModel(tc.model)
    model.load_state_dict(from_jax_params(params, tc))
    model.eval()
    jds = JaxProbeDataset(root, snippet_samples=SNIPPET)
    ds = ProbeDataset(root, snippet_samples=SNIPPET)
    with jax.default_matmul_precision("highest"):
        spk = jp.extract_speaker_frame_features(jmodel, params, jds,
                                                max_snippets=72)
        phone = jp.extract_phone_frame_features(jmodel, params, jds,
                                                max_snippets=40)
    return dict(root=root, jmodel=jmodel, params=params, model=model,
                jds=jds, ds=ds, spk=spk, phone=phone)


def test_probe_dataset_matches_jax(setup):
    jds, ds = setup["jds"], setup["ds"]
    assert ds.speaker_to_id == jds.speaker_to_id
    assert ds.num_speakers == jds.num_speakers == 4
    assert len(ds) == len(jds)
    for i in range(len(ds)):
        assert ds.speaker_of(i) == jds.speaker_of(i)
        x, spk, ph = ds.item_with_labels(i)
        jx, jspk, jph = jds.item_with_labels(i)
        np.testing.assert_array_equal(x, jx)
        assert spk == jspk
        np.testing.assert_array_equal(ph, jph)


def test_short_or_missing_phone_labels_give_none(tmp_path):
    root = str(tmp_path / "c")
    generate_synthetic_corpus(root, num_speakers=2, files_per_speaker=2,
                              seconds_per_file=1.0, seed=3)
    labs = sorted(p for p in (tmp_path / "c").rglob("*.phones.npy"))
    np.save(labs[0], np.load(labs[0])[:12000])   # 2 of its 3 snippets
    os.remove(labs[1])
    ds, jds = (cls(root, snippet_samples=5000)
               for cls in (ProbeDataset, JaxProbeDataset))
    got = [ds.item_with_labels(i)[2] is None for i in range(len(ds))]
    want = [jds.item_with_labels(i)[2] is None for i in range(len(jds))]
    assert got == want == [False, False, True, True, True, True,
                           False, False, False, False, False, False]


@pytest.mark.parametrize("n,frac,seed", [(1, 0.25, 0), (72, 0.25, 0),
                                         (200, 0.1, 3), (9, 0.5, 7)])
def test_split_matches_jax(n, frac, seed):
    for a, b in zip(tp._split(n, frac, seed), jp._split(n, frac, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split", ["snippet", "file"])
@pytest.mark.parametrize("seed", [0, 2])
def test_split_items_matches_jax(split, seed):
    files = [f"f{i % 7}" for i in range(45)]
    for a, b in zip(tp._split_items(45, files, split, 0.25, seed),
                    jp._split_items(45, files, split, 0.25, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("time_pool", ["mean", "last", "max"])
def test_pool_time_matches_jax(time_pool):
    feats = np.random.default_rng(1).standard_normal((5, 7, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(tp.pool_time(feats, time_pool),
                                  jp.pool_time(feats, time_pool))


@pytest.mark.parametrize("feature", ["c", "z"])
def test_extract_matches_jax(setup, feature):
    # 40 snippets: a full batch of 32 and one padded with zero snippets
    snippets = np.stack([setup["ds"][i] for i in range(40)])
    with jax.default_matmul_precision("highest"):
        want = jp._extract(setup["jmodel"], setup["params"], snippets,
                           feature)
    got = tp._extract(setup["model"], snippets, feature)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_frame_features_and_labels_match_jax(setup):
    feats, lab, files = tp.extract_phone_frame_features(
        setup["model"], setup["ds"], max_snippets=40)
    jfeats, jlab, jfiles = setup["phone"]
    np.testing.assert_array_equal(lab, jlab)
    assert files == jfiles
    np.testing.assert_allclose(feats, jfeats, rtol=0, atol=1e-5)
    pooled, y, sfiles = tp.extract_speaker_features(
        setup["model"], setup["ds"], max_snippets=72, time_pool="last")
    np.testing.assert_array_equal(y, setup["spk"][1])
    assert sfiles == setup["spk"][2]
    np.testing.assert_allclose(pooled, setup["spk"][0][:, -1], rtol=0,
                               atol=1e-5)


def _standardized(x_tr, x_ev):
    mu = x_tr.mean(axis=0, keepdims=True)
    sd = x_tr.std(axis=0, keepdims=True) + 1e-6
    return (x_tr - mu) / sd, (x_ev - mu) / sd


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_from_jax_w0_matches_optax(setup, seed):
    feats, lab, files = setup["phone"]
    N, T, d = feats.shape
    tr, ev = jp._split_items(N, files, "snippet", 0.25, seed)
    x = feats.reshape(N, T, d)
    x_tr, x_ev = _standardized(x[tr].reshape(-1, d), x[ev].reshape(-1, d))
    y_tr = lab[tr].reshape(-1)
    C = int(lab.max()) + 1
    w0 = jax.random.normal(jax.random.key(seed), (d, C)) * 0.01
    b0 = jnp.zeros((C,))
    params = {"w": w0, "b": b0}
    opt = optax.adam(1e-2)
    state = opt.init(params)

    def loss_fn(p):
        logits = x_tr @ p["w"] + p["b"]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y_tr).mean()

    @jax.jit
    def step(params, state):
        updates, state = opt.update(jax.grad(loss_fn)(params), state)
        return optax.apply_updates(params, updates), state

    with jax.default_matmul_precision("highest"):
        for _ in range(50):
            params, state = step(params, state)
        jpred = np.asarray(x_ev @ params["w"] + params["b"]).argmax(-1)
    w, b = tp._fit_linear(torch.from_numpy(x_tr), torch.from_numpy(y_tr),
                          torch.from_numpy(np.array(w0)),
                          torch.from_numpy(np.array(b0)), steps=50, lr=1e-2)
    np.testing.assert_allclose(w.numpy(), np.asarray(params["w"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(params["b"]), rtol=0,
                               atol=1e-5)
    pred = (torch.from_numpy(x_ev) @ w + b).argmax(-1).numpy()
    np.testing.assert_array_equal(pred, jpred)


def test_init_linear_is_seeded():
    w0, b0 = tp._init_linear(64, 5, seed=3)
    assert w0.shape == (64, 5) and torch.equal(b0, torch.zeros(5))
    assert torch.equal(w0, tp._init_linear(64, 5, seed=3)[0])
    assert not torch.equal(w0, tp._init_linear(64, 5, seed=4)[0])
    assert 0.005 < float(w0.std()) < 0.015


@pytest.mark.parametrize("probe", ["speaker", "phone"])
def test_train_linear_accuracy_within_the_band_of_jax(setup, probe):
    if probe == "speaker":
        pooled, y, files = setup["spk"]
        x = jp.pool_time(pooled, "mean")
        tr, ev = jp._split_items(len(x), files, "file", 0.25, 0)
        args = (x[tr], y[tr], x[ev], y[ev], 4)
    else:
        feats, lab, files = setup["phone"]
        N, T, d = feats.shape
        tr, ev = jp._split_items(N, files, "snippet", 0.25, 0)
        args = (feats[tr].reshape(-1, d), lab[tr].reshape(-1),
                feats[ev].reshape(-1, d), lab[ev].reshape(-1), 5)
    n_eval = len(args[3])
    for seed in range(3):
        got = tp._train_linear(*args, seed=seed, device="cpu")
        with jax.default_matmul_precision("highest"):
            want = jp._train_linear(*args, seed=seed)
        assert abs(got - want) <= max(2 / n_eval, 0.01), (seed, got, want)


def test_value_errors(setup):
    pooled = np.zeros((6, 4), np.float32)
    y = np.arange(6) % 2
    files = [f"f{i}" for i in range(6)]
    with pytest.raises(ValueError, match="split must be"):
        tp.probe_speaker_features(pooled, y, files, 2, split="x",
                                  device="cpu")
    with pytest.raises(ValueError, match="split must be"):
        tp.probe_speaker_features(pooled, y, files, 2, split="x",
                                  pool="utterance", device="cpu")
    with pytest.raises(ValueError, match="pool must be"):
        tp.probe_speaker_features(pooled, y, files, 2, pool="file",
                                  device="cpu")
    with pytest.raises(ValueError, match="time_pool"):
        tp.pool_time(np.zeros((2, 3, 4)), "median")
    with pytest.raises(ValueError, match="0 train"):
        tp.probe_speaker_features(pooled[:1], y[:1], files[:1], 2,
                                  device="cpu")
    with pytest.raises(ValueError, match="phone probe split"):
        tp.probe_phone_features(np.zeros((1, 3, 4), np.float32),
                                np.zeros((1, 3), np.int64), ["f"],
                                device="cpu")
    with pytest.raises(ValueError, match="probe_seeds must be >= 1"):
        battery.probe_milestone(setup["model"], setup["ds"], normalize=True,
                                probe_seeds=0)


def test_phone_probe_without_labels_raises(tmp_path):
    root = str(tmp_path / "c")
    generate_synthetic_corpus(root, num_speakers=2, files_per_speaker=1,
                              seconds_per_file=1.0, seed=3,
                              write_labels=False)
    cfg = tcfg.ModelConfig(
        encoder=tcfg.EncoderConfig(channels=(8, 8), kernels=(10, 8),
                                   strides=(5, 4), d_enc=8),
        ar=tcfg.ArConfig(d_ar=8))
    with pytest.raises(ValueError, match="phones.npy"):
        tp.run_phone_probe(CPCModel(cfg).eval(),
                           ProbeDataset(root, snippet_samples=4000))


def test_fit_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no GPU")
    # torch's own error: AssertionError in a CPU build, RuntimeError in a
    # CUDA build on a machine without a card
    with pytest.raises((AssertionError, RuntimeError)):
        tp.probe_speaker_features(np.zeros((8, 4), np.float32),
                                  np.arange(8) % 2,
                                  [f"f{i}" for i in range(8)], 2)


def _sized_fit(x_tr, y_tr, x_ev, y_ev, num_classes, *, steps, seed,
               **_):
    """A stand-in for both packages' _train_linear: a number made of what
    the battery hands the fit (sizes, width, labels, classes, steps, seed),
    so that two batteries that plumb their probes alike give one row."""
    return (len(x_tr) + 3 * len(x_ev) + 5 * x_tr.shape[-1]
            + 7 * int(np.sum(y_tr)) + 11 * int(np.sum(y_ev))
            + 13 * num_classes + steps + 17 * seed) % 9973 / 9973


def test_battery_plumbs_its_probes_as_jax_does(setup, monkeypatch):
    monkeypatch.setattr(jp, "_train_linear", _sized_fit)
    monkeypatch.setattr(tp, "_train_linear", _sized_fit)
    with jax.default_matmul_precision("highest"):
        want = jbattery.probe_milestone(setup["jmodel"], setup["params"],
                                        setup["jds"], normalize=True,
                                        probe_seeds=2)
    got = battery.probe_milestone(setup["model"], setup["ds"],
                                  normalize=True, probe_seeds=2)
    assert len(got) == 18 and got == want


TINY = ["--config", "tpu_fast", "--data", "synthetic", "--device", "cpu",
        "--batch-size", "4", "--snippet-samples", "2560",
        "--set", "model.encoder.channels=16,16,16,16,16",
        "--set", "model.encoder.d_enc=16", "--set", "model.ar.d_ar=16",
        "--set", "model.loss.prediction_steps=3"]
ROW_KEYS = ["checkpoint_step", "speaker_file_acc", "speaker_file_acc_std",
            "speaker_file_last_acc", "speaker_file_last_acc_std",
            "speaker_file_max_acc", "speaker_file_max_acc_std",
            "speaker_file_eval_n", "speaker_acc", "speaker_acc_std",
            "speaker_eval_n", "speaker_classes", "speaker_utt_acc",
            "speaker_utt_eval_n", "phone_file_acc", "phone_file_acc_std",
            "phone_snip_acc", "phone_eval_n", "phone_classes"]


def _eval(capsys, workdir, *extra):
    capsys.readouterr()
    assert eval_cli.main(["--workdir", str(workdir), "--device", "cpu",
                          *extra]) == 0
    return [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]


def _check_probe_line(line, step):
    assert list(line) == ["checkpoint_step", "feature", "speaker_probe",
                          "phone_probe"]
    assert line["checkpoint_step"] == step
    for k in ("speaker_probe", "phone_probe"):
        assert list(line[k]) == ["accuracy", "num_classes", "num_train",
                                 "num_eval", "feature"]
        assert 0.0 <= line[k]["accuracy"] <= 1.0


def test_cli_probes_a_workdir_the_train_cli_wrote(tmp_path, capsys):
    assert train_cli.main([*TINY, "--workdir", str(tmp_path),
                           "--steps", "2"]) == 0
    (row,) = _eval(capsys, tmp_path, "--battery", "--probe-seeds", "1")
    assert list(row) == ROW_KEYS and row["checkpoint_step"] == 2
    assert row["speaker_classes"] == 8 and row["phone_classes"] == 5
    (line,) = _eval(capsys, tmp_path, "--probe", "both", "--steps", "50",
                    "--split", "file", "--time-pool", "last",
                    "--max-snippets", "64")
    _check_probe_line(line, 2)
    (z_line,) = _eval(capsys, tmp_path, "--probe", "phone", "--feature", "z",
                      "--steps", "20", "--max-snippets", "16")
    assert list(z_line) == ["checkpoint_step", "feature", "phone_probe"]
    assert z_line["phone_probe"]["feature"] == "z"


def test_cli_probes_jax_params_npz(setup, tmp_path, capsys):
    # rule C1: the CLI reads a workdir another program wrote, here the JAX
    # package's params flattened to jax_params.npz beside its config.json;
    # its battery row is the library's on the same weights, which gives the
    # same row again (the determinism contract). A small corpus of its own
    # keeps the CPU fits short.
    cfg = dataclasses.replace(
        jcfg.presets.baseline(), model=setup["jmodel"].config,
        data=dataclasses.replace(jcfg.presets.baseline().data,
                                 snippet_samples=SNIPPET))
    wd = tmp_path / "run"
    wd.mkdir()
    (wd / "config.json").write_text(json.dumps(jcfg.to_dict(cfg)))
    np.savez(wd / "jax_params.npz", **flatten_params(setup["params"]))
    corpus = str(tmp_path / "corpus")
    generate_synthetic_corpus(corpus, num_speakers=3, files_per_speaker=2,
                              seconds_per_file=1.0, seed=5)
    (line,) = _eval(capsys, wd, "--data", corpus, "--steps", "50")
    _check_probe_line(line, 0)
    ds = ProbeDataset(corpus, snippet_samples=SNIPPET)
    want = tp.run_speaker_probe(setup["model"], ds, steps=50)
    assert line["speaker_probe"] == dataclasses.asdict(want)
    (row,) = _eval(capsys, wd, "--data", corpus, "--battery",
                   "--probe-seeds", "1")
    assert list(row) == ROW_KEYS and row.pop("checkpoint_step") == 0
    assert all(0.0 <= v <= 1.0 for k, v in row.items()
               if k.endswith(("_acc", "_acc_std")))
    assert battery.probe_milestone(setup["model"], ds, normalize=True,
                                   probe_seeds=1) == row


def test_cli_unported_flags_raise(tmp_path, capsys):
    # every flag is ported: --packed runs (tests/test_torch_port_feed.py),
    # and the --export-* flags export (tests/test_torch_port_export.py);
    # without --export-model they raise as the JAX CLI's p.error does
    for flag in (["--export-streaming", "4"], ["--export-streams", "2"],
                 ["--export-stats", "0", "1"]):
        with pytest.raises(SystemExit) as e:
            eval_cli.main(["--workdir", str(tmp_path), *flag])
        assert e.value.code == 2
        assert f"{flag[0]} requires --export-model" in capsys.readouterr().err


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--workdir", str(tmp_path), "--battery"])
