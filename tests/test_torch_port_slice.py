"""The port's feature-extraction path as a whole against the JAX package:
CPCModel (z, c, preds), `extract_features`, and the `--extract` CLI, with
the JAX side's GRU on the Pallas kernel (`ar.use_pallas=True`, interpret
mode on the CPU) and weights carried across by `from_jax_params`. fp32 at
narrow widths, 1e-4. Also pins that the port imports no jax."""

import ast
import dataclasses
import json
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
from cpc_tpu_torch import CPCModel, extract_features
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.eval.cli import main as cli_main
from cpc_tpu_torch.interop import (flatten_params, from_jax_params,
                                   unflatten_params)

REPO = Path(__file__).resolve().parent.parent
WINDOW = 2560  # 16 latents


def _cfg(norm="none", num_layers=1):
    return jcfg.CPCConfig(
        name="narrow",
        model=jcfg.ModelConfig(
            encoder=jcfg.EncoderConfig(channels=(16,) * 5, d_enc=16,
                                       norm=norm),
            ar=jcfg.ArConfig(d_ar=16, num_layers=num_layers,
                             use_pallas=True),
            loss=jcfg.LossConfig(prediction_steps=3)),
        data=jcfg.DataConfig(snippet_samples=WINDOW, batch_size=2))


def _pair(cfg, seed=0):
    """JAX model + params drawn from a numpy seed, and the port's model
    (config through to_dict/from_dict, weights through from_jax_params)."""
    jmodel = JaxCPCModel(cfg.model)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, WINDOW)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("bias", "bi", "bh"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                ).astype(np.float32)

    params = {"params": jax.tree_util.tree_map_with_path(draw, shapes)}
    tc = tcfg.from_dict(jcfg.to_dict(cfg))
    model = CPCModel(tc.model)
    model.load_state_dict(from_jax_params(params, tc))
    return jmodel, params, model.eval()


def _wave(n, seed=1):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("norm,num_layers", [("none", 1), ("layer", 2)])
def test_cpc_model_matches_jax(norm, num_layers):
    jmodel, params, model = _pair(_cfg(norm, num_layers), seed=num_layers)
    x = _wave(2 * WINDOW).reshape(2, WINDOW)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jmodel.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.preds.shape == (2, 16, 3, 16)
    for name in ("z", "c", "preds"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_standalone_methods_match_jax():
    jmodel, params, model = _pair(_cfg(num_layers=2), seed=4)
    x = _wave(WINDOW, seed=2)[None]
    h0 = np.random.default_rng(3).uniform(-0.5, 0.5, (2, 1, 16)
                                          ).astype(np.float32)
    m = JaxCPCModel
    with jax.default_matmul_precision("highest"):
        jz = jmodel.apply(params, jnp.asarray(x), method=m.encode)
        jc = jmodel.apply(params, jnp.asarray(x), method=m.context)
        jl = jmodel.apply(params, jnp.asarray(x), method=m.latents)
        jcs, jst = jmodel.apply(params, jz, jnp.asarray(h0),
                                method=m.context_with_state)
    with torch.no_grad():
        tx = torch.from_numpy(x)
        z = model.encode(tx)
        pairs = [(z, jz), (model.context(tx), jc)]
        pairs += list(zip(model.latents(tx), jl))
        pairs += list(zip(model.context_with_state(z, torch.from_numpy(h0)),
                          (jcs, jst)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("hop", [WINDOW, WINDOW // 2])
def test_extract_features_matches_jax(hop):
    jmodel, params, model = _pair(_cfg(), seed=5)
    wave = _wave(3 * WINDOW + 1000, seed=6)
    with jax.default_matmul_precision("highest"):
        jz, jc = jax_extract(jmodel, params, wave, window=WINDOW, hop=hop,
                             batch_windows=2)
    z, c = extract_features(model, wave, window=WINDOW, hop=hop,
                            batch_windows=2)
    assert z.shape == jz.shape == (len(wave) // 160, 16)
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-4)
    np.testing.assert_allclose(c, jc, rtol=0, atol=1e-4)


def test_extract_features_rejects_bad_hop():
    _, _, model = _pair(_cfg())
    for hop in (0, WINDOW + 1):
        with pytest.raises(ValueError, match="hop"):
            extract_features(model, _wave(WINDOW), window=WINDOW, hop=hop)
    with pytest.raises(ValueError, match="multiples"):
        extract_features(model, _wave(2 * WINDOW), window=WINDOW, hop=1000)


def test_params_npz_round_trip(tmp_path):
    _, params, model = _pair(_cfg(norm="layer"), seed=7)
    np.savez(tmp_path / "p.npz", **flatten_params(params))
    with np.load(tmp_path / "p.npz") as npz:
        tree = unflatten_params(npz)
    tc = tcfg.from_dict(jcfg.to_dict(_cfg(norm="layer")))
    sd = from_jax_params(tree, tc)
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def _workdir(tmp_path, with_params=True):
    cfg = _cfg()
    jmodel, params, _ = _pair(cfg, seed=8)
    wd = tmp_path / "wd"
    wd.mkdir()
    (wd / "config.json").write_text(json.dumps(jcfg.to_dict(cfg)))
    if with_params:
        np.savez(wd / "jax_params.npz", **flatten_params(params))
    wav = str(tmp_path / "a.wav")
    write_wav(wav, _wave(2 * WINDOW + 700, seed=9) * 0.5, 16000)
    return jmodel, params, wd, wav


@pytest.mark.parametrize("hop", [None, 1280])
def test_cli_extract_end_to_end(tmp_path, hop):
    jmodel, params, wd, wav = _workdir(tmp_path)
    out = str(tmp_path / "f.npz")
    cmd = [sys.executable, "-m", "cpc_tpu_torch.eval", "--extract", wav,
           "--workdir", str(wd), "--out", out, "--device", "cpu"]
    if hop:
        cmd += ["--hop", str(hop)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["out"] == out and report["device"] == "cpu"
    wave, _ = jax_decode_mono(wav, 16000)
    with jax.default_matmul_precision("highest"):
        jz, jc = jax_extract(jmodel, params, wave, window=WINDOW, hop=hop)
    with np.load(out) as f:
        assert f["z"].shape == jz.shape == tuple(report["z_shape"])
        np.testing.assert_allclose(f["z"], jz, rtol=0, atol=1e-4)
        np.testing.assert_allclose(f["c"], jc, rtol=0, atol=1e-4)


def test_cli_without_params_warns(tmp_path, capsys):
    _, _, wd, wav = _workdir(tmp_path, with_params=False)
    assert cli_main(["--extract", wav, "--workdir", str(wd),
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "randomly initialized" in json.loads(lines[0])["warning"]
    assert json.loads(lines[-1])["c_shape"] == [(2 * WINDOW + 700) // 160, 16]


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no GPU")
    _, _, wd, wav = _workdir(tmp_path, with_params=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--extract", wav, "--workdir", str(wd), "--device", "cuda"])


@pytest.mark.parametrize("kw", [dict(kind="transformer", attn_impl="ring"),
                                dict(remat=True)])
def test_unported_gar_raises(kw):
    # the context-parallel attention runs only inside a CP mesh (a plain
    # forward raises, as JAX's outside shard_map), and ar.remat has no
    # meaning for the GRU
    mc = tcfg.presets.baseline().model
    mc = dataclasses.replace(mc, ar=dataclasses.replace(mc.ar, **kw))
    with pytest.raises((NotImplementedError, ValueError)):
        CPCModel(mc)(torch.zeros(1, 1600))


def test_maestro_scalogram_builds_with_the_jax_tree():
    # the scalogram encoder is ported: the model builds at full width, and
    # its state_dict has exactly the keys and shapes from_jax_params makes
    # of the JAX model's params
    cfg = jcfg.presets.maestro_scalogram()
    shapes = jax.eval_shape(JaxCPCModel(cfg.model).init, jax.random.key(0),
                            jnp.zeros((1, 20480)))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tc = tcfg.from_dict(jcfg.to_dict(cfg))
    model = CPCModel(tc.model)
    sd = from_jax_params(params, tc)
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    model.load_state_dict(sd)


SLICE_MODULES = [
    "cpc_tpu_torch", "cpc_tpu_torch.config", "cpc_tpu_torch.interop",
    "cpc_tpu_torch.ops.dsp", "cpc_tpu_torch.ops.gru_cuda",
    "cpc_tpu_torch.ops.infonce", "cpc_tpu_torch.ops.infonce_fused",
    "cpc_tpu_torch.ops.infonce_cuda",
    "cpc_tpu_torch.ops.infonce_allsteps_cuda",
    "cpc_tpu_torch.ops.attention_cuda", "cpc_tpu_torch.models.transformer",
    "cpc_tpu_torch.ops.conv_cuda", "cpc_tpu_torch.ops.scalogram",
    "cpc_tpu_torch.train.profile_step",
    "cpc_tpu_torch.ops._build", "cpc_tpu_torch.models.encoder",
    "cpc_tpu_torch.models.gru", "cpc_tpu_torch.models.cpc",
    "cpc_tpu_torch.data.wavio", "cpc_tpu_torch.data.dataset",
    "cpc_tpu_torch.data.synthetic", "cpc_tpu_torch.data.loader",
    "cpc_tpu_torch.eval.features", "cpc_tpu_torch.eval.cli",
    "cpc_tpu_torch.eval.probes", "cpc_tpu_torch.eval.battery",
    "cpc_tpu_torch.eval.streaming", "cpc_tpu_torch.serve",
    "cpc_tpu_torch.eval.__main__", "cpc_tpu_torch.train.train_step",
    "cpc_tpu_torch.train.metrics", "cpc_tpu_torch.train.checkpoint",
    "cpc_tpu_torch.train.trainer", "cpc_tpu_torch.train.cli",
    "cpc_tpu_torch.train.__main__", "cpc_tpu_torch.parallel",
    "cpc_tpu_torch.parallel.mesh", "cpc_tpu_torch.parallel.multihost",
    "cpc_tpu_torch.parallel.dp", "cpc_tpu_torch.data.flac",
    "cpc_tpu_torch.data.flac_encoder", "cpc_tpu_torch.data.packed",
    "cpc_tpu_torch.data.pack", "cpc_tpu_torch.train.supervisor",
    "cpc_tpu_torch.utils", "cpc_tpu_torch.utils.profiling",
    "cpc_tpu_torch.export", "cpc_tpu_torch.ops.ring_util",
    "cpc_tpu_torch.ops.infonce_ring", "cpc_tpu_torch.ops.attention_ring",
    "cpc_tpu_torch.ops.attention_zigzag", "cpc_tpu_torch.parallel.cp",
    "cpc_tpu_torch.parallel.tp", "cpc_tpu_torch.utils.precision"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cpc_tpu")


def test_port_imports_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in SLICE_MODULES)
            + f"bad = [m for m in sys.modules if m.split('.')[0] in "
              f"{FORBIDDEN!r}]\n"
            + "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in (REPO / "cpc_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_import_anywhere_in_the_port(path):
    # also catches imports inside functions, which the subprocess misses
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"
