"""The transformer slice as a whole against the JAX package: a narrow
`transformer_gar`-shaped `CPCModel` (2 blocks), two training steps with the
preset's warmup and clipping, `extract_features`, and both CLIs on the CPU.

The JAX side runs 'flash' through its Pallas kernels in interpret mode, and
the fused heads + InfoNCE likewise, at
`jax.default_matmul_precision('highest')`; weights cross by
`from_jax_params`, batches are numpy.

Tolerances of the training steps, as tests/test_torch_port_train_step.py:
  * fp32: loss and grad_norm 1e-4 relative, each gradient 1e-4 of its
    largest entry, accuracy exact.
  * bf16 compute (`dtype=bfloat16`, `pallas_bf16`): loss and grad_norm 1e-2
    relative; gradients 3e-2 of their largest entry, the encoder's 0.15 (the
    spread of JAX's own bf16 gradients around its fp32 ones, measured there);
    accuracy one row per k.
  * parameters after Adam: a gradient error e moves an entry by at most
    about 2 lr min(1, 2 e / |g|) per step, plus 1e-6.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc_tpu import config as jcfg
from cpc_tpu.data.dataset import decode_mono as jax_decode_mono
from cpc_tpu.data.wavio import write_wav
from cpc_tpu.eval.features import extract_features as jax_extract
from cpc_tpu.models.cpc import CPCModel as JaxCPCModel
from cpc_tpu.parallel.mesh import make_mesh
from cpc_tpu.train.train_step import make_step_fns as jax_make_step_fns
from cpc_tpu_torch import CPCModel, extract_features
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.eval.cli import main as eval_main
from cpc_tpu_torch.interop import flatten_params, from_jax_params
from cpc_tpu_torch.train import cli as train_cli
from cpc_tpu_torch.train.train_step import dropout_generator, make_step_fns

REPO = Path(__file__).resolve().parent.parent
BATCH, SAMPLES, LR, K = 4, 2000, 2e-4, 2
TOL = {"float32": dict(scalar=1e-4, grad=1e-4, encoder_grad=1e-4, acc=0.0),
       "bfloat16": dict(scalar=1e-2, grad=3e-2, encoder_grad=0.15,
                        acc=None)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(impl="flash", dtype="float32", fuse_heads=True):
    """transformer_gar's shape and recipe (warmup, clipping) at a narrow
    width: 100 latents of 20 samples, 2 blocks of 4 heads."""
    bf16 = dtype == "bfloat16"
    return jcfg.CPCConfig(
        name="narrow_transformer",
        model=jcfg.ModelConfig(
            encoder=jcfg.EncoderConfig(channels=(16, 16), kernels=(10, 8),
                                       strides=(5, 4), d_enc=16),
            ar=jcfg.ArConfig(kind="transformer", d_ar=16, num_layers=2,
                             num_heads=4, mlp_ratio=2, max_len=128,
                             attn_impl=impl),
            loss=jcfg.LossConfig(prediction_steps=K, use_pallas=True,
                                 fuse_heads=fuse_heads, pallas_bf16=bf16),
            dtype=dtype),
        data=jcfg.DataConfig(batch_size=BATCH, snippet_samples=SAMPLES),
        train=jcfg.TrainConfig(learning_rate=LR, warmup_steps=2,
                               grad_clip_norm=1.0))


def _params(cfg, seed=0):
    shapes = jax.eval_shape(JaxCPCModel(cfg.model).init, jax.random.key(0),
                            jnp.zeros((1, SAMPLES)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "pos_embed":
            return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        if len(s.shape) == 3 and path[-2].key in ("query", "key", "value"):
            fan_in = s.shape[0]
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                ).astype(np.float32)
    return {"params": jax.tree_util.tree_map_with_path(draw, shapes)}


def _pair(cfg, seed=0):
    params = _params(cfg, seed)
    tc = tcfg.from_dict(jcfg.to_dict(cfg))
    model = CPCModel(tc.model)
    model.load_state_dict(from_jax_params(params, tc))
    return JaxCPCModel(cfg.model), params, tc, model


def _wave(n, seed=1):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_cpc_model_matches_jax(impl):
    jmodel, params, _, model = _pair(_cfg(impl), seed=1)
    x = _wave(2 * SAMPLES).reshape(2, SAMPLES)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply(params, jnp.asarray(x))
        jz, jc_tm = jmodel.apply(params, jnp.asarray(x),
                                 method=JaxCPCModel.latents_tm)
        jctx = jmodel.apply(params, jnp.asarray(x),
                            method=JaxCPCModel.context)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        z, c_tm = model.latents_tm(torch.from_numpy(x))
        ctx = model.context(torch.from_numpy(x))
    assert got.preds.shape == (2, 100, K, 16) and c_tm.shape == (100, 2, 16)
    for name in ("z", "c", "preds"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(c_tm.numpy(), np.asarray(jc_tm), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), rtol=0,
                               atol=1e-4)
    assert torch.equal(c_tm.transpose(0, 1), got.c)


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [np.clip(rng.standard_normal((BATCH, SAMPLES)) * 6000, -32768,
                    32767).astype(np.int16) for _ in range(n)]


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _check_step(tc, jm, tm, jgrads, model, params, tol, sens, n_step):
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=tol["scalar"])
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=tol["scalar"])
    Tp = SAMPLES // 20 - K
    acc_tol = tol["acc"] if tol["acc"] is not None else 1.0 / (Tp * BATCH)
    np.testing.assert_allclose(tm["acc"].numpy(), np.asarray(jm["acc"]),
                               rtol=0, atol=acc_tol + 1e-7)
    want_g = from_jax_params(jax.tree.map(np.asarray, jgrads), tc)
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want_g[name].numpy()
        gtol = tol["encoder_grad" if name.startswith("encoder.") else "grad"]
        if name.endswith("attn.key.bias"):
            # its true gradient is zero (a shift of every key leaves the
            # softmax as it was): both sides hold rounding noise, bounded
            # here against the key weight's gradient
            scale = np.abs(want_g[name.replace("bias", "weight")].numpy()
                           ).max()
            assert np.abs(g - w).max() <= gtol * scale, name
            sens[name] = np.ones_like(w)
            continue
        assert _rel(g, w) <= gtol, (name, _rel(g, w))
        e = gtol * np.abs(w).max()
        step_sens = np.minimum(1.0, 2 * e / np.maximum(np.abs(w), 1e-30))
        sens[name] = np.maximum(sens.get(name, 0.0), step_sens)
    want_p = from_jax_params(jax.tree.map(np.asarray, params), tc)
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - want_p[name].numpy())
        bound = 2 * LR * n_step * sens[name] + 1e-6
        assert (d <= bound).all(), (name, (d - bound).max())


@pytest.mark.parametrize("dtype,fuse_heads", [
    ("float32", True), ("float32", False), ("bfloat16", True),
    ("bfloat16", False)])
def test_two_train_steps_match_jax(dtype, fuse_heads):
    cfg = _cfg("flash", dtype, fuse_heads)
    jmodel, params, tc, model = _pair(cfg)
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    jsteps = jax_make_step_fns(cfg, jmodel, mesh)
    opt_state = jsteps.optimizer.init(params)
    steps = make_step_fns(tc, model)
    tol, sens = TOL[dtype], {}
    grad_fn = jax.jit(jax.grad(lambda p, b: jsteps.loss_fn(p, b)[0]))
    with jax.default_matmul_precision("highest"):
        for n_step, batch in enumerate(_batches(3), 1):
            jgrads = grad_fn(params, jnp.asarray(batch))
            before = jax.tree.map(np.asarray, params)
            params, opt_state, jm = jsteps.train_step(params, opt_state,
                                                      jnp.asarray(batch))
            tm = steps.train_step(torch.from_numpy(batch))
            if n_step == 1:  # warmup: the first update has learning rate 0
                jax.tree.map(np.testing.assert_array_equal, before,
                             jax.tree.map(np.asarray, params))
                assert float(jm["grad_norm"]) > 1.0  # so the clip is live
            _check_step(tc, jm, tm, jgrads, model, params, tol, sens, n_step)


@pytest.mark.parametrize("hop", [SAMPLES, SAMPLES // 2])
def test_extract_features_matches_jax(hop):
    jmodel, params, _, model = _pair(_cfg("flash"), seed=5)
    wave = _wave(3 * SAMPLES + 700, seed=6)
    with jax.default_matmul_precision("highest"):
        jz, jc = jax_extract(jmodel, params, wave, window=SAMPLES, hop=hop,
                             batch_windows=2)
    z, c = extract_features(model.eval(), wave, window=SAMPLES, hop=hop,
                            batch_windows=2)
    assert z.shape == jz.shape and c.shape == jc.shape == (len(wave) // 20,
                                                           16)
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-4)
    np.testing.assert_allclose(c, jc, rtol=0, atol=1e-4)


def test_extract_cli_loads_a_transformer_workdir(tmp_path, capsys):
    cfg = _cfg("flash16")
    jmodel, params, _, _ = _pair(cfg, seed=7)
    (tmp_path / "config.json").write_text(json.dumps(jcfg.to_dict(cfg)))
    np.savez(tmp_path / "jax_params.npz", **flatten_params(params))
    wav = str(tmp_path / "a.wav")
    write_wav(wav, _wave(2 * SAMPLES + 300, seed=8) * 0.5, 16000)
    out = str(tmp_path / "f.npz")
    assert eval_main(["--extract", wav, "--workdir", str(tmp_path), "--out",
                      out, "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    wave, _ = jax_decode_mono(wav, 16000)
    with jax.default_matmul_precision("highest"):
        jz, jc = jax_extract(jmodel, params, wave, window=SAMPLES)
    with np.load(out) as f:
        assert list(f["c"].shape) == report["c_shape"] == list(jc.shape)
        np.testing.assert_allclose(f["z"], jz, rtol=0, atol=1e-4)
        # flash16 rounds P and V to bf16 on both sides (one tile: T <= 128)
        np.testing.assert_allclose(f["c"], jc, rtol=0, atol=2e-3)


def test_context_with_state_raises():
    _, _, _, model = _pair(_cfg("xla"))
    with pytest.raises(ValueError, match="GRU gar"):
        model.context_with_state(torch.zeros(1, 10, 16))
    mc = dataclasses.replace(tcfg.presets.baseline().model,
                             ar=tcfg.ArConfig(kind="lstm"))
    with pytest.raises(ValueError, match="unknown ar kind"):
        CPCModel(mc)


def test_presets_build_at_full_width():
    # on the meta device: shapes only, no memory
    for name in ("transformer_gar", "transformer_fast"):
        cfg = tcfg.presets.by_name(name)
        with torch.device("meta"):
            gar = CPCModel(cfg.model).gar
        assert gar.pos_embed.shape == (2048, 256)
        assert gar.block1.fc1.weight.shape == (1024, 256)
        assert gar.in_proj.weight.shape == (256, 512)
        assert gar.block0.attn.num_heads == 8
        assert cfg.train.warmup_steps == 1000
        assert cfg.train.grad_clip_norm == 1.0


TINY = ["--config", "transformer_gar", "--data", "synthetic", "--device",
        "cpu", "--batch-size", "4", "--snippet-samples", "2560",
        "--set", "model.encoder.channels=16,16,16,16,16",
        "--set", "model.encoder.d_enc=16", "--set", "model.ar.d_ar=16",
        "--set", "model.ar.num_heads=4", "--set", "model.ar.max_len=32",
        "--set", "model.loss.prediction_steps=3",
        "--set", "train.warmup_steps=2", "--set", "train.checkpoint_every=2",
        "--set", "train.log_every=1", "--set", "train.eval_every=100"]


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _final(workdir, step):
    return torch.load(os.path.join(workdir, "checkpoints", f"step_{step}.pt"),
                      weights_only=True)


@pytest.mark.parametrize("extra", [
    ["--set", "model.ar.attn_impl=flash16"],
    ["--set", "model.ar.dropout=0.2"],
    ["--set", "model.ar.attn_impl=flash", "--set", "model.ar.remat=true",
     "--set", "model.loss.use_pallas=true", "--set",
     "model.loss.fuse_heads=true"]])
def test_train_cli_resume_is_exact(tmp_path, extra):
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    args = [*TINY, *extra]
    assert train_cli.main([*args, "--workdir", straight, "--steps", "4"]) == 0
    assert train_cli.main([*args, "--workdir", split, "--steps", "2"]) == 0
    assert train_cli.main([*args, "--workdir", split, "--steps", "4",
                           "--resume"]) == 0
    recs = [r for r in _records(straight) if r["prefix"] == "train"]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    for r in recs:
        assert len(r["acc"]) == 3
        assert all(np.isfinite([r["loss"], r["grad_norm"], *r["acc"]]))
    a, b = _final(straight, 4), _final(split, 4)
    assert a["meta"] == b["meta"] and a["optimizer"]["count"] == 4
    assert any(k.startswith("gar.block1.attn.query") for k in a["model"])
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0, msg=k)
    for moment in ("mu", "nu"):
        for k, v in a["optimizer"][moment].items():
            torch.testing.assert_close(b["optimizer"][moment][k], v, rtol=0,
                                       atol=0)


def test_dropout_generator_depends_on_seed_step_and_microbatch():
    def draw(*key):
        return torch.rand(4, generator=dropout_generator(*key, "cpu"))
    base = draw(0, 5, 0)
    assert torch.equal(base, draw(0, 5, 0))
    for other in ((1, 5, 0), (0, 6, 0), (0, 5, 1)):
        assert not torch.equal(base, draw(*other))


def test_dropout_is_live_in_training_and_off_in_evaluation():
    cfg = _cfg("xla")
    tc = tcfg.from_dict(jcfg.to_dict(cfg))
    tc = dataclasses.replace(tc, model=dataclasses.replace(
        tc.model, ar=dataclasses.replace(tc.model.ar, dropout=0.3)))
    model = CPCModel(tc.model, generator=torch.Generator().manual_seed(0))
    steps = make_step_fns(tc, model)
    batch = torch.from_numpy(_batches(1)[0])
    plain = steps.loss_fn(model, batch)[0].item()
    assert steps.eval_step(batch)["loss"].item() == plain
    a = steps.loss_fn(model, batch, dropout_generator(0, 0, 0, "cpu"))[0]
    b = steps.loss_fn(model, batch, dropout_generator(0, 0, 0, "cpu"))[0]
    c = steps.loss_fn(model, batch, dropout_generator(0, 1, 0, "cpu"))[0]
    assert a.item() == b.item() and a.item() != plain and a.item() != c.item()


def test_module_entry_point_trains_the_transformer(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "cpc_tpu_torch.train", *TINY, "--steps", "2",
         "--workdir", str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "config=transformer_gar device=cpu" in proc.stdout
    assert _records(tmp_path)[-1]["step"] == 2
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg["model"]["ar"]["kind"] == "transformer"
