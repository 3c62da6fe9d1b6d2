"""What surrounds the port's redesigned GRU kernels, on the CPU.

* The backward kernels are three stages (gates of all steps at once, the
  reversed recurrence that consumes them, the sums for dwh and dbh).
  `gru_gates_reference` and `gru_scan_backward_split_reference` are that
  split in plain PyTorch: equal to `gru_scan_backward_reference` (1e-6 in
  fp32, bit for bit in bf16) and to `jax.grad` of the JAX package's Pallas
  `gru_scan` in interpret mode at `highest` precision, within the bounds of
  tests/test_torch_port_gru_bwd.py (1e-5 in fp32; 2e-3 in bf16, a quarter of
  a bf16 ulp of gradients of magnitude about 2).
* `gru_route`: which kernels a shape takes on the card.
* The extraction CLI restores what the training CLI wrote.
* The GRU module in bf16 with `use_pallas=False` against the JAX module's
  `lax.scan` path, which carries h in bf16. Measured here with the modules'
  own initialisation (orthogonal wh, lecun-normal wi, biases of 0.1):
  max |c_port - c_jax| = 7.8e-3 at (B, T, D, H, L) = (4, 40, 16, 32, 2),
  1.4e-2 at (4, 128, 16, 32, 1) and 1.2e-2 at (8, 128, 32, 64, 2), with
  max |c| = 0.99; a tensor-code recurrence that carries h in bf16 measured
  9.8e-3, 1.4e-2 and 9.8e-3 on the same inputs. The bound is the 2e-2 of the
  other bf16 GRU tests: two bf16 recurrences round at different places, and
  128 steps carry that on.

The kernels themselves run only on a GPU: tests/test_torch_port_cuda.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc_tpu.models.gru import GRU as JaxGRU
from cpc_tpu.ops.gru_pallas import gru_scan as jax_gru_scan
from cpc_tpu_torch import extract_features, presets
from cpc_tpu_torch.data.wavio import decode_mono
from cpc_tpu_torch.eval import cli as eval_cli
from cpc_tpu_torch.models.gru import GRU
from cpc_tpu_torch.ops.gru_cuda import (gru_gates_reference, gru_route,
                                        gru_scan_backward_reference,
                                        gru_scan_backward_split_reference,
                                        gru_scan_reference)
from cpc_tpu_torch.train import cli as train_cli

NAMES = ("dxproj", "dwh", "dbh", "dh0")
PRESETS = [n for n in dir(presets) if not n.startswith("_") and n != "by_name"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny tensors: one intra-op thread, so that parallel test workers do
    # not oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, B, 3 * H)).astype(np.float32),
            (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32),
            (rng.standard_normal(3 * H) * 0.1).astype(np.float32),
            rng.uniform(-0.9, 0.9, (B, H)).astype(np.float32),
            rng.standard_normal((T, B, H)).astype(np.float32))


def _torch_args(args, dtype):
    xp, wh, bh, h0, g = (torch.from_numpy(a) for a in args)
    return xp.to(dtype), wh.to(dtype), bh.to(dtype), h0, g.to(dtype)


SHAPES = [(9, 3, 16), (6, 2, 8), (1, 1, 4), (33, 5, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,B,H", SHAPES)
def test_split_backward_equals_the_plain_backward(T, B, H, dtype):
    xp, wh, bh, h0, g = _torch_args(_inputs(T, B, H, seed=T + H), dtype)
    hs = gru_scan_reference(xp, wh, bh, h0)
    want = gru_scan_backward_reference(xp, wh, bh, h0, hs, g)
    got = gru_scan_backward_split_reference(xp, wh, bh, h0, hs, g)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if dtype == torch.bfloat16:
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_gates_reference_is_the_forward_s_gates(dtype):
    # stage 1 recomputes, for every step at once, what the forward computed
    # step by step: replaying h from its gates gives the forward's output
    T, B, H = 9, 3, 16
    xp, wh, bh, h0, _ = _torch_args(_inputs(T, B, H, seed=4), dtype)
    hs = gru_scan_reference(xp, wh, bh, h0)
    r, z, n, hn = gru_gates_reference(xp, wh, bh, h0, hs)
    for a in (r, z, n, hn):
        assert a.dtype == torch.float32 and a.shape == (T, B, H)
    hprev = torch.cat([h0.to(dtype)[None], hs[:-1]]).float()
    replay = ((1.0 - z) * n + z * hprev).to(dtype)
    # the forward carries h in fp32 and stage 1 starts each step from the
    # rounded output: equal in fp32, within one rounding of h in bf16
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    assert (replay.float() - hs.float()).abs().max().item() <= tol
    torch.testing.assert_close(
        n, torch.tanh(xp[..., 2 * H:].float() + r * hn), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 2e-3)],
    ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,B,H", SHAPES[:3])
def test_split_backward_matches_pallas(T, B, H, dtype, jdtype, tol):
    args = _inputs(T, B, H, seed=T + H)
    g = args[4]

    def loss(xp, wh, bh, h0):
        hs = jax_gru_scan(xp, wh, bh, h0, True)
        return jnp.sum(hs.astype(jnp.float32) * g)

    with jax.default_matmul_precision("highest"):
        want = jax.grad(loss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a, jdtype) for a in args[:3]), jnp.asarray(args[3]))
    xp, wh, bh, h0, gt = _torch_args(args, dtype)
    hs = gru_scan_reference(xp, wh, bh, h0)
    got = gru_scan_backward_split_reference(xp, wh, bh, h0, hs, gt)
    for name, a, w in zip(NAMES, got, want):
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(w.astype(jnp.float32)), rtol=0,
            atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", PRESETS)
def test_every_preset_takes_the_resident_route(name, dtype):
    cfg = presets.by_name(name)
    assert cfg.model.ar.d_ar == 256
    assert gru_route(cfg.data.batch_size, cfg.model.ar.d_ar,
                     dtype) == "resident"


@pytest.mark.parametrize("B,H,dtype,route", [
    (1, 256, torch.bfloat16, "resident"),    # the streaming state path
    (1, 256, torch.float32, "resident"),
    (65, 256, torch.bfloat16, "resident"),   # a ragged last tile
    (64, 32, torch.float32, "resident"),     # a cluster of one block
    (64, 128, torch.bfloat16, "resident"),
    (64, 40, torch.float32, "streamed"),     # no whole number of warps
    (64, 96, torch.bfloat16, "streamed"),    # 3 blocks: no cluster shape
    (64, 512, torch.bfloat16, "streamed"),   # 16 blocks: beyond a cluster
    (64, 1024, torch.bfloat16, "streamed"),  # 768 KB of wh a block
    (1, 1024, torch.float32, "streamed")])
def test_route_by_shape(B, H, dtype, route):
    assert gru_route(B, H, dtype) == route


def test_route_rejects_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        gru_route(4, 256, torch.float16)
    with pytest.raises(ValueError):
        gru_route(0, 256, torch.float32)


TINY = ["--config", "tpu_fast", "--data", "synthetic", "--device", "cpu",
        "--batch-size", "4", "--snippet-samples", "2560",
        "--set", "model.encoder.channels=16,16,16,16,16",
        "--set", "model.encoder.d_enc=16", "--set", "model.ar.d_ar=16",
        "--set", "model.loss.prediction_steps=3",
        "--set", "train.log_every=1"]


def _extract(workdir, wav, capsys, *extra):
    capsys.readouterr()
    out = workdir / "features.npz"
    assert eval_cli.main(["--extract", str(wav), "--workdir", str(workdir),
                          "--device", "cpu", "--out", str(out), *extra]) == 0
    lines = [json.loads(line)
             for line in capsys.readouterr().out.strip().splitlines()]
    with np.load(out) as f:
        return lines, f["z"], f["c"]


def test_extraction_restores_the_training_checkpoint(tmp_path, monkeypatch,
                                                     capsys):
    # train 2 steps, extract from that workdir: the features are those of
    # the trainer's own model, not of a randomly initialized one
    trainers = []

    class Kept(train_cli.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            trainers.append(self)

    monkeypatch.setattr(train_cli, "Trainer", Kept)
    assert train_cli.main([*TINY, "--workdir", str(tmp_path),
                           "--steps", "2"]) == 0
    (trainer,) = trainers
    wav = sorted((tmp_path / "synthetic_corpus").rglob("*.wav"))[0]
    lines, z, c = _extract(tmp_path, wav, capsys)
    assert len(lines) == 1 and lines[0]["checkpoint_step"] == 2
    cfg = trainer.cfg
    wave, _ = decode_mono(str(wav), cfg.data.sample_rate)
    want_z, want_c = extract_features(
        trainer.model.eval(), wave, window=cfg.data.snippet_samples,
        normalize=cfg.data.normalize)
    np.testing.assert_array_equal(z, want_z)
    np.testing.assert_array_equal(c, want_c)

    # and not those of the seed's initial weights, which an empty workdir
    # with the same config gives, with a warning and step 0
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text((tmp_path / "config.json").read_text())
    lines, z0, c0 = _extract(empty, wav, capsys)
    assert "warning" in lines[0] and lines[1]["checkpoint_step"] == 0
    assert not (empty / "checkpoints").exists()
    assert np.abs(c - c0).max() > 0


def _gru_pair(D, H, L, seed, use_pallas):
    """The port's bf16 GRU with its own initialisation (biases set to 0.1
    normal) and the JAX module's params with the same weights."""
    tgru = GRU(D, H, num_layers=L, dtype=torch.bfloat16,
               generator=torch.Generator().manual_seed(seed),
               use_pallas=use_pallas)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for layer in tgru.layers():
            for b in (layer.bi, layer.bh):
                b.copy_(torch.from_numpy(
                    rng.standard_normal(b.shape).astype(np.float32) * 0.1))
    params = {"params": {f"layer{n}": {
        k: jnp.asarray(getattr(layer, k).detach().numpy())
        for k in ("wi", "bi", "wh", "bh")}
        for n, layer in enumerate(tgru.layers())}}
    return tgru, params


@pytest.mark.parametrize("B,T,D,H,L", [(4, 40, 16, 32, 2), (4, 128, 16, 32, 1),
                                       (8, 128, 32, 64, 2)])
def test_bf16_module_without_use_pallas_is_within_the_band_of_lax_scan(
        B, T, D, H, L):
    tgru, params = _gru_pair(D, H, L, seed=0, use_pallas=False)
    assert tgru.use_pallas is False
    x = np.random.default_rng(7).standard_normal((B, T, D)).astype(np.float32)
    jgru = JaxGRU(hidden_size=H, num_layers=L, use_pallas=False,
                  dtype=jnp.bfloat16)
    want = np.asarray(jgru.apply(params, jnp.asarray(x)).astype(jnp.float32))
    got = tgru(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    gap = np.abs(got.float().detach().numpy() - want).max()
    assert gap <= 2e-2  # measured 7.8e-3, 1.4e-2, 1.2e-2 (module docstring)
    # use_pallas is kept on the module and changes no number
    with_flag, _ = _gru_pair(D, H, L, seed=0, use_pallas=True)
    assert with_flag.use_pallas is True
    assert torch.equal(with_flag(torch.from_numpy(x)), got)


def test_model_passes_use_pallas_to_its_gru():
    from cpc_tpu_torch import CPCModel
    from cpc_tpu_torch.config import apply_overrides
    tiny = ["model.encoder.channels=8,8,8,8,8", "model.encoder.d_enc=8",
            "model.ar.d_ar=8", "model.loss.prediction_steps=2"]
    for flag in ("true", "false"):
        cfg = apply_overrides(presets.tpu_fast(),
                              [*tiny, f"model.ar.use_pallas={flag}"])
        model = CPCModel(cfg.model)
        assert model.gar.use_pallas is (flag == "true")
        assert all(layer.use_pallas is (flag == "true")
                   for layer in model.gar.layers())
