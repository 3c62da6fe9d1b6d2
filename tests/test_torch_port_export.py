"""The port's serving export (cpc_tpu_torch/export.py), the eval CLI's
`--export-*` flags, `serve --artifact` and the decoder hook, on the CPU.

The artifacts are held against the live port model, the port's
StreamingExtractor and the JAX package's own artifacts
(`cpc_tpu/export.py`, run through `jax.export` at 'highest' matmul
precision) on the same weights (`from_jax_params`): the extractor at 1e-5,
the streaming steps chunk by chunk at the stream tolerances of
tests/test_torch_port_streaming.py. Their graphs call aten, prims and
operator functions only (no ctypes kernel, no custom op), and a `.pt2`
loads and runs in a process that imports torch alone. The CLI exports from
a workdir that the port's training CLI wrote, and rejects the flag
combinations the JAX CLI rejects, with its messages.
"""

import dataclasses
import functools
import io
import json
import operator
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from cpc_tpu import config as jcfg
from cpc_tpu import export as jexport
from cpc_tpu.data import dataset as jdataset
from cpc_tpu.eval import cli as jeval_cli
from cpc_tpu.models.cpc import CPCModel as JaxCPCModel
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch import export, serve
from cpc_tpu_torch.config import to_dict
from cpc_tpu_torch.data import dataset as tdataset
from cpc_tpu_torch.data.wavio import DECODERS, INFOS, write_wav
from cpc_tpu_torch.eval import cli as eval_cli
from cpc_tpu_torch.eval.cli import load_weights
from cpc_tpu_torch.eval.streaming import StreamingExtractor, receptive_field
from cpc_tpu_torch.interop import from_jax_params
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.ops.dsp import prepare_waveform
from cpc_tpu_torch.train import cli as train_cli

Z_TOL = dict(rtol=1e-5, atol=1e-5)
C_TOL = {"gru": dict(rtol=1e-5, atol=1e-5),
         "transformer": dict(rtol=1e-5, atol=2e-5)}
SNIPPET = 2000
N_LATENTS = 4
TINY = ["--config", "tpu_fast", "--data", "synthetic", "--device", "cpu",
        "--batch-size", "4", "--snippet-samples", "2560",
        "--set", "model.encoder.channels=16,16,16,16,16",
        "--set", "model.encoder.d_enc=16", "--set", "model.ar.d_ar=16",
        "--set", "model.loss.prediction_steps=3"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors: one intra-op thread, so that parallel test workers do
    # not oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(ar_kind="gru", channels=24, **ar):
    heads = {"num_heads": 2, "max_len": 64} if ar_kind == "transformer" \
        else {}
    return jcfg.ModelConfig(
        encoder=jcfg.EncoderConfig(kind="conv1d", channels=(channels,) * 3,
                                   kernels=(10, 8, 4), strides=(5, 4, 2),
                                   d_enc=channels),
        ar=jcfg.ArConfig(kind=ar_kind, d_ar=16, **{**heads, **ar}))


@functools.lru_cache(maxsize=None)
def _pair(jmc, init_len=SNIPPET):
    """(JAX model, its params, the port's model with the same weights)."""
    jmodel = JaxCPCModel(jmc)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  np.zeros((1, init_len), np.float32))
    tc = tcfg.from_dict(jcfg.to_dict(jcfg.CPCConfig(model=jmc)))
    model = CPCModel(tc.model)
    model.load_state_dict(from_jax_params(params, tc))
    return jmodel, params, model.eval()


@functools.lru_cache(maxsize=None)
def _extractors(ar_kind):
    """(the port's extractor program, JAX's exported extractor, the port's
    live model), symbolic batch, made once a module."""
    jmodel, params, model = _pair(_jax_cfg(ar_kind))
    with jax.default_matmul_precision("highest"):
        jexp = jexport.export_extractor(jmodel, params,
                                        snippet_samples=SNIPPET,
                                        platforms=("cpu",))
    return export.export_extractor(model, snippet_samples=SNIPPET), jexp, \
        model


@functools.lru_cache(maxsize=None)
def _steps(ar_kind, stats=None):
    """(the port's streaming-step program, JAX's, the port's live model)."""
    jmodel, params, model = _pair(_jax_cfg(ar_kind))
    with jax.default_matmul_precision("highest"):
        jexp = jexport.export_streaming_step(jmodel, params,
                                             chunk_latents=N_LATENTS,
                                             stats=stats, platforms=("cpu",))
    return export.export_streaming_step(model, chunk_latents=N_LATENTS,
                                        stats=stats), jexp, model


def _wave(n, seed, rows=None):
    shape = (n,) if rows is None else (rows, n)
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3
            ).astype(np.float32)


OPERATOR_FNS = {f for f in vars(operator).values() if callable(f)}


def _targets(ep):
    return {n.target for n in ep.graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("ar_kind", ["gru", "transformer"])
def test_extractor_matches_live_and_jax(ar_kind, batch):
    ep, jexp, model = _extractors(ar_kind)
    x = _wave(SNIPPET, seed=batch, rows=batch) * 3
    with torch.no_grad():
        z, c = ep.module()(torch.from_numpy(x))
        z_live, c_live = model.latents(prepare_waveform(torch.from_numpy(x)))
    assert z.shape == (batch, SNIPPET // 40, 24) and c.shape[-1] == 16
    np.testing.assert_allclose(z.numpy(), z_live.numpy(), **Z_TOL)
    np.testing.assert_allclose(c.numpy(), c_live.numpy(), **Z_TOL)
    with jax.default_matmul_precision("highest"):
        jz, jc = jexp.call(x)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **Z_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **Z_TOL)


def test_pinned_batch_rejects_another_batch():
    jmodel, params, model = _pair(_jax_cfg("transformer"))
    ep = export.export_extractor(model, snippet_samples=SNIPPET, batch=3)
    z, c = ep.module()(torch.zeros(3, SNIPPET))
    assert z.shape[0] == c.shape[0] == 3
    with pytest.raises(AssertionError, match="Guard failed"):
        ep.module()(torch.zeros(4, SNIPPET))
    with pytest.raises(ValueError) as want:
        jexport.export_extractor(jmodel, params, snippet_samples=SNIPPET,
                                 batch=0)
    with pytest.raises(ValueError) as got:
        export.export_extractor(model, snippet_samples=SNIPPET, batch=0)
    assert str(got.value) == str(want.value)


def _drive(fn, ep, wave, windows):
    """Threads a streaming step over `windows` fixed windows of `wave`,
    from zero state; returns the concatenated (z, c) and the final state."""
    ins = [np.zeros(t.shape, {torch.float32: np.float32,
                              torch.int32: np.int32}[t.dtype])
           for t in export.avals(ep)[0][:-1]]
    rf, down = receptive_field((10, 8, 4), (5, 4, 2))
    W, hop = rf + (N_LATENTS - 1) * down, N_LATENTS * down
    zs, cs = [], []
    for j in range(windows):
        z, c, *ins = fn(*ins, wave[None, j * hop:j * hop + W])
        zs.append(np.asarray(z)[0])
        cs.append(np.asarray(c)[0])
    return np.concatenate(zs), np.concatenate(cs), ins


@pytest.mark.parametrize("ar_kind,stats", [("gru", None),
                                           ("gru", (0.1, 2.0)),
                                           ("transformer", None)])
def test_streaming_step_matches_extractor_and_jax(ar_kind, stats):
    ep, jexp, model = _steps(ar_kind, stats)
    rf, down = receptive_field((10, 8, 4), (5, 4, 2))
    windows = 5
    wave = _wave(rf + (windows * N_LATENTS - 1) * down, seed=11)
    mod = ep.module()

    def port(*args):
        with torch.no_grad():
            return [t.numpy() for t in mod(*map(torch.from_numpy, args))]
    z, c, state = _drive(port, ep, wave, windows)
    assert z.shape == (windows * N_LATENTS, 24)
    ex = StreamingExtractor(model, stats=stats)
    z_live, c_live = [], []
    for a in range(0, len(wave), 777):   # chunks that are not windows
        zz, cc = ex.push(wave[a:a + 777])
        z_live.append(zz)
        c_live.append(cc)
    np.testing.assert_allclose(z, np.concatenate(z_live), **Z_TOL)
    np.testing.assert_allclose(c, np.concatenate(c_live), **C_TOL[ar_kind])
    with jax.default_matmul_precision("highest"):
        jz, jc, jstate = _drive(jexp.call, ep, wave, windows)
    np.testing.assert_allclose(z, jz, **Z_TOL)
    np.testing.assert_allclose(c, jc, **C_TOL[ar_kind])
    for got, want in zip(state, jstate):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_allclose(got, np.asarray(want), **C_TOL[ar_kind])
    if ar_kind == "transformer":
        assert state[2].tolist() == [windows * N_LATENTS]


@pytest.mark.parametrize("kw", [dict(chunk_latents=0),
                                dict(chunk_latents=2, n_streams=0),
                                dict(chunk_latents=2, stats=(0.0, 0.0)),
                                dict(chunk_latents=2,
                                     stats=(float("nan"), 1.0)),
                                dict(chunk_latents=2, encoder="scalogram")])
def test_streaming_step_rejections_match_jax(kw):
    kw = dict(kw)
    jmc = _jax_cfg()
    if kw.pop("encoder", None):
        jmc = dataclasses.replace(jmc, encoder=dataclasses.replace(
            jmc.encoder, kind="scalogram"))
        jmodel = JaxCPCModel(jmc)
        params = None
        model = CPCModel(tcfg.from_dict(jcfg.to_dict(
            jcfg.CPCConfig(model=jmc))).model)
    else:
        jmodel, params, model = _pair(jmc)
    with pytest.raises(ValueError) as want:
        jexport.export_streaming_step(jmodel, params, platforms=("cpu",),
                                      **kw)
    with pytest.raises(ValueError) as got:
        export.export_streaming_step(model, **kw)
    assert str(got.value) == str(want.value)


def test_bf16_artifact_halves_and_stays_close(tmp_path):
    # wide enough that the weights, not the graph, fill the file
    _, _, model = _pair(_jax_cfg("transformer", channels=256))
    full = export.export_extractor(model, snippet_samples=SNIPPET)
    half = export.export_extractor(model, snippet_samples=SNIPPET,
                                   params_dtype="bfloat16")
    b_full = export.save_artifact(str(tmp_path / "f.pt2"), full)["bytes"]
    b_half = export.save_artifact(str(tmp_path / "h.pt2"), half)["bytes"]
    assert b_half < 0.6 * b_full, (b_half, b_full)
    x = torch.from_numpy(_wave(SNIPPET, seed=5, rows=2))
    with torch.no_grad():
        z_f, _ = full.module()(x)
        z_h, _ = export.load_artifact(str(tmp_path / "h.pt2")).module()(x)
    assert z_h.dtype == torch.float32
    err = float((z_h - z_f).abs().max() / (z_f.abs().max() + 1e-9))
    assert 0 < err < 0.05, err


def test_scalogram_extractor_exports():
    """The scalogram front end (`torch.fft.rfft` in the graph) exports and
    matches the live model and JAX's artifact."""
    jmc = jcfg.ModelConfig(
        encoder=jcfg.EncoderConfig(
            kind="scalogram", d_enc=32, scalogram_n_fft=256,
            scalogram_hop=160, scalogram_n_bins=32,
            scalogram_channels=(16, 32),
            scalogram_kernels=((3, 3), (3, 3)),
            scalogram_freq_strides=(2, 2), scalogram_time_strides=(1, 1)),
        ar=jcfg.ArConfig(d_ar=16))
    jmodel = JaxCPCModel(jmc)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  np.zeros((1, 3200), np.float32))
    tc = tcfg.from_dict(jcfg.to_dict(jcfg.CPCConfig(model=jmc)))
    model = CPCModel(tc.model)
    model.load_state_dict(from_jax_params(params, tc))
    ep = export.export_extractor(model.eval(), snippet_samples=3200)
    assert any("fft" in str(t) for t in _targets(ep))
    x = _wave(3200, seed=2, rows=2)
    with torch.no_grad():
        z, c = ep.module()(torch.from_numpy(x))
        z_live, c_live = model.latents(prepare_waveform(torch.from_numpy(x)))
    np.testing.assert_allclose(z.numpy(), z_live.numpy(), **Z_TOL)
    np.testing.assert_allclose(c.numpy(), c_live.numpy(), **Z_TOL)
    with jax.default_matmul_precision("highest"):
        jexp = jexport.export_extractor(jmodel, params, snippet_samples=3200,
                                        platforms=("cpu",))
        jz, jc = jexp.call(x)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **Z_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **Z_TOL)


@pytest.mark.parametrize("kind", ["extractor gru", "extractor transformer",
                                  "step gru", "step transformer"])
def test_graph_calls_only_aten(kind):
    """No ctypes kernel and no custom op: every call is an aten or prims
    overload, or an operator function (the symbolic batch's arithmetic)."""
    which, ar_kind = kind.split()
    ep = (_extractors if which == "extractor" else _steps)(ar_kind)[0]
    for t in _targets(ep):
        if isinstance(t, torch._ops.OpOverload):
            assert t.namespace in ("aten", "prims"), t
        else:
            assert t in OPERATOR_FNS, t


def test_pt2_runs_in_a_process_with_torch_alone(tmp_path):
    ep, _, _ = _steps("gru")
    path = str(tmp_path / "step.pt2")
    export.save_artifact(path, ep)
    state, win = (torch.zeros(t.shape) for t in export.avals(ep)[0])
    win = torch.from_numpy(_wave(win.shape[1], seed=3)[None])
    torch.save({"h": state, "win": win}, tmp_path / "in.pt")
    script = textwrap.dedent(f"""
        import sys, torch
        ep = torch.export.load({path!r})
        args = torch.load({str(tmp_path / "in.pt")!r})
        with torch.no_grad():
            out = ep.module()(args["h"], args["win"])
        torch.save(list(out), {str(tmp_path / "out.pt")!r})
        assert not [m for m in sys.modules if m.startswith("cpc_tpu")]
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = torch.load(tmp_path / "out.pt")
    with torch.no_grad():
        want = ep.module()(state, win)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------ the eval CLI
@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("run")
    assert train_cli.main([*TINY, "--workdir", str(wd), "--steps", "1"]) == 0
    return wd


def _trained(wd):
    with open(wd / "config.json") as f:
        cfg = tcfg.from_dict(json.load(f))
    model = CPCModel(cfg.model)
    assert load_weights(model, str(wd), cfg) == 1
    return cfg, model.eval()


def _eval_row(capsys, argv):
    assert eval_cli.main(argv) == 0
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def test_cli_exports_the_extractor_of_a_trained_workdir(workdir, tmp_path,
                                                        capsys):
    path = str(tmp_path / "m.pt2")
    (row,) = _eval_row(capsys, ["--workdir", str(workdir), "--device",
                                "cpu", "--export-model", path])
    cfg, model = _trained(workdir)
    side = json.load(open(path + ".json"))
    assert row == {"checkpoint_step": 1, "export": path, "device": "cpu",
                   "platforms": ["cpu", "cuda"],
                   "in_avals": ["f32[b,2560]"],
                   "out_avals": ["bf16[b,16,16]", "bf16[b,16,16]"],
                   "bytes": os.path.getsize(path)}
    assert tcfg.from_dict(side["config"]) == cfg
    assert side["kernels"] == "plain"
    assert side["fn_name"] == "extractor" and side["format_version"] == 1
    x = torch.from_numpy(_wave(2560, seed=9, rows=2))
    with torch.no_grad():
        z, c = export.load_artifact(path, "cpu").module()(x)
        z_live, c_live = model.latents(prepare_waveform(x))
    # tpu_fast computes in bf16: the same bf16 graph on the same device
    assert torch.equal(z, z_live) and torch.equal(c, c_live)


def test_cli_exports_the_streaming_step(workdir, tmp_path, capsys):
    path = str(tmp_path / "s.pt2")
    lines = _eval_row(capsys, ["--workdir", str(workdir), "--device", "cpu",
                               "--export-model", path,
                               "--export-streaming", "3",
                               "--export-streams", "2"])
    assert "per-snippet-NORMALIZED" in lines[0]["warning"]
    assert lines[1]["in_avals"] == ["f32[1,2,16]", "f32[2,785]"]
    (row,) = _eval_row(capsys, ["--workdir", str(workdir), "--device", "cpu",
                                "--export-model", path,
                                "--export-streaming", "3",
                                "--export-stats", "0.0", "0.5"])
    assert row["in_avals"] == ["f32[1,1,16]", "f32[1,785]"]
    assert json.load(open(path + ".json"))["fn_name"] == "gru_step"


FLAG_ERRORS = [
    ["--export-streaming", "4"], ["--export-streams", "2"],
    ["--export-batch", "2"], ["--export-dtype", "bfloat16"],
    ["--export-stats", "0", "1"],
    ["--export-model", "m", "--export-streaming", "4", "--export-batch",
     "2"],
    ["--export-model", "m", "--export-streaming", "4", "--export-dtype",
     "bfloat16"],
    ["--export-model", "m", "--export-stats", "0", "1"]]


@pytest.mark.parametrize("flags", FLAG_ERRORS,
                         ids=[" ".join(f) for f in FLAG_ERRORS])
def test_cli_flag_errors_match_jax(flags, tmp_path, capsys):
    argv = ["--workdir", str(tmp_path), *flags]
    with pytest.raises(SystemExit) as want:
        jeval_cli.main(argv)
    jax_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        eval_cli.main([*argv, "--device", "cpu"])
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert err.split("error: ")[1] == jax_err.split("error: ")[1]


# ------------------------------------------------------------ the server
def _serve(argv, pcm: bytes):
    out, err = io.BytesIO(), io.StringIO()
    assert serve.main([*argv, "--device", "cpu"], stdin=io.BytesIO(pcm),
                      stdout=out, stderr=err) == 0
    return out.getvalue(), [json.loads(line)
                            for line in err.getvalue().splitlines()]


@pytest.fixture(scope="module")
def stream_artifact(workdir, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("art") / "s.pt2")
    assert eval_cli.main(["--workdir", str(workdir), "--device", "cpu",
                          "--export-model", path, "--export-streaming",
                          "5"]) == 0
    return path


def test_serve_artifact_matches_workdir(workdir, stream_artifact):
    # 7 windows of 5 latents, then 2 latents and 123 samples more: the
    # live path emits those 2, the artifact drops them with the tail
    rf, down = 465, 160
    n = rf + (7 * 5 + 1) * down + 123
    q = np.clip(np.random.default_rng(4).standard_normal(n) * 3000, -32768,
                32767).astype("<i2")
    args = ["--emit", "zc", "--in-format", "i16", "--chunk-samples", "1001"]
    raw, lines = _serve(["--artifact", stream_artifact, *args], q.tobytes())
    live, live_lines = _serve(["--workdir", str(workdir), *args], q.tobytes())
    frames = np.frombuffer(raw, "<f4").reshape(-1, 32)
    want = np.frombuffer(live, "<f4").reshape(-1, 32)
    assert frames.shape == (35, 32) and want.shape == (37, 32)
    assert lines[0] == live_lines[0]
    assert lines[-1] == {"frames": 35, "dropped_tail_samples": n - 7 * 800,
                         "dropped_partial_bytes": 0}
    # the same fp32 computation over every complete window
    np.testing.assert_array_equal(frames, want[:35])


def test_serve_artifact_steps_with_tf32_off(stream_artifact, monkeypatch):
    """The artifact's convs follow the process's cuDNN settings, and torch's
    default lets cuDNN take TF32: the server calls the program with TF32
    off, as StreamingExtractor.push runs, and restores the settings."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    stream = serve._ArtifactStream(stream_artifact, "cpu")
    program, seen = stream._fn, []

    def spy(*args):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return program(*args)
    stream._fn = spy
    z, c = stream.push(_wave(2 * stream.window, seed=8))
    assert len(z) == len(c) > 0 and seen and set(seen) == {(False, False)}
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (True, True)


def test_serve_artifact_info_header(workdir, stream_artifact):
    raw, lines = _serve(["--artifact", stream_artifact, "--info", "--emit",
                         "c"], b"\x00" * 64)
    _, live = _serve(["--workdir", str(workdir), "--info", "--emit", "c"],
                     b"")
    assert raw == b"" and len(lines) == len(live) == 1
    assert lines[0] == live[0] == {
        "emit": "c", "frame_dim": 16, "frame_stride_samples": 160,
        "receptive_field_samples": 465, "d_enc": 16, "d_ar": 16}


def test_serve_artifact_errors(workdir, tmp_path):
    batched = str(tmp_path / "b.pt2")
    assert eval_cli.main(["--workdir", str(workdir), "--device", "cpu",
                          "--export-model", batched, "--export-streaming",
                          "2", "--export-streams", "2"]) == 0
    with pytest.raises(SystemExit, match="n_streams=2"):
        _serve(["--artifact", batched], b"")
    extractor = str(tmp_path / "e.pt2")
    assert eval_cli.main(["--workdir", str(workdir), "--device", "cpu",
                          "--export-model", extractor]) == 0
    with pytest.raises(SystemExit, match="not a streaming-step artifact"):
        _serve(["--artifact", extractor], b"")
    single = str(tmp_path / "s.pt2")
    assert eval_cli.main(["--workdir", str(workdir), "--device", "cpu",
                          "--export-model", single, "--export-streaming",
                          "2"]) == 0
    os.remove(single + ".json")
    with pytest.raises(SystemExit, match="cannot read encoder geometry"):
        _serve(["--artifact", single], b"")


def test_serve_transformer_artifact_stops_at_the_table(tmp_path):
    """max_len 12 latents, 5 a step: the third step would pass the table,
    so the server stops after two, where the live path raises too."""
    jmc = _jax_cfg("transformer", max_len=12)
    _, _, model = _pair(jmc, init_len=400)
    cfg = dataclasses.replace(tcfg.presets.baseline(), model=model.config)
    path = str(tmp_path / "t.pt2")
    export.save_artifact(path, export.export_streaming_step(
        model, chunk_latents=5), meta={"config": to_dict(cfg)})
    wave = _wave(105 + 14 * 40, seed=6)   # 15 latents' receptive fields
    out, err = io.BytesIO(), io.StringIO()
    with pytest.raises(SystemExit, match="positional table \\(12"):
        serve.main(["--artifact", path, "--device", "cpu",
                    "--chunk-samples", "80"], stdin=io.BytesIO(
                        wave.tobytes()), stdout=out, stderr=err)
    assert len(out.getvalue()) == 10 * 16 * 4   # two steps were served
    with pytest.raises(ValueError, match="positional table"):
        StreamingExtractor(model).push(_wave(105 + 12 * 40, seed=6))


# ------------------------------------------------------- the decoder hook
@pytest.fixture
def stub_format():
    """Registers `.stub` (a .npy of int16 samples at 16 kHz) in both
    packages and removes it after the test."""
    def read(path):
        return np.load(path, allow_pickle=False).astype(np.float32)[
            :, None] / 32768.0, 16000

    def info(path):
        return int(np.load(path, mmap_mode="r").shape[0]), 16000
    yield read, info
    for table in (DECODERS, INFOS, jdataset._DECODERS, jdataset._INFOS):
        table.pop(".stub", None)


def _stub_corpus(root):
    rng = np.random.default_rng(8)
    for spk in ("a", "b"):
        os.makedirs(root / spk)
        for i in range(2):
            x = (rng.standard_normal(3000) * 2000).astype(np.int16)
            if i:
                with open(root / spk / f"u{i}.stub", "wb") as f:
                    np.save(f, x)
            else:
                write_wav(str(root / spk / f"u{i}.wav"),
                          x.astype(np.float32) / 32768.0, 16000)
    (root / "notes.txt").write_text("not audio")


@pytest.mark.parametrize("with_info", [True, False])
def test_register_decoder_matches_jax(stub_format, tmp_path, with_info):
    read, info = stub_format
    _stub_corpus(tmp_path)
    before = tdataset.list_audio_files(str(tmp_path))
    assert before == jdataset.list_audio_files(str(tmp_path))
    assert [os.path.basename(p) for p in before] == ["u0.wav", "u0.wav"]
    tdataset.register_decoder(".STUB", read, info if with_info else None)
    jdataset.register_decoder(".STUB", read, info if with_info else None)
    files = tdataset.list_audio_files(str(tmp_path))
    assert files == jdataset.list_audio_files(str(tmp_path))
    assert len(files) == 4
    assert tdataset.list_audio_files(str(tmp_path), exts=[".stub"]) == \
        jdataset.list_audio_files(str(tmp_path), exts=[".stub"]) == \
        [f for f in files if f.endswith(".stub")]
    ours = tdataset.SnippetDataset(str(tmp_path), 1000, 1000, 16000,
                                   device="cpu")
    theirs = jdataset.SnippetDataset(str(tmp_path), 1000, 1000, 16000)
    assert ours.files == theirs.files == files and len(ours) == 12
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours[i], theirs[i])
        np.testing.assert_array_equal(ours.snippet_int16(i),
                                      theirs.snippet_int16(i))
