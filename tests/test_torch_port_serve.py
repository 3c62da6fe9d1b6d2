"""The port's feature server (cpc_tpu_torch/serve.py) on the CPU: raw PCM on
stdin -> float32 frames on stdout, through `main` with in-memory streams.

The frames equal a StreamingExtractor fed the same chunks (bit for bit:
the same calls on the same device), f32 and i16 stdin decode as the JAX
server decodes them (`_to_f32` against `cpc_tpu.serve._to_f32`), and the
JAX server's own `main`, run around a stand-in for its live stream that
pushes into the port's extractor, writes the same stdout and stderr as the
port's. The `--artifact` backend is held in tests/test_torch_port_export.py.
"""

import io
import json

import numpy as np
import pytest
import torch

from cpc_tpu import serve as jserve
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch import serve
from cpc_tpu_torch.eval.cli import load_weights
from cpc_tpu_torch.eval.streaming import StreamingExtractor
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.train import cli as train_cli

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


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("run")
    assert train_cli.main([*TINY, "--workdir", str(wd), "--steps", "1"]) == 0
    return wd


def _run(argv, pcm: bytes):
    out, err = io.BytesIO(), io.StringIO()
    rc = serve.main(argv, stdin=io.BytesIO(pcm), stdout=out, stderr=err)
    assert rc == 0
    return out.getvalue(), [json.loads(line)
                            for line in err.getvalue().splitlines()]


def _extractor(wd, **kw):
    with open(wd / "config.json") as f:
        cfg = tcfg.from_dict(json.load(f))
    model = CPCModel(cfg.model)
    assert load_weights(model, str(wd), cfg) == 1
    return StreamingExtractor(model, **kw)


def _reference(ex, wave, chunk, emit):
    outs = []
    for a in range(0, len(wave), chunk):
        z, c = ex.push(wave[a:a + chunk])
        outs.append({"c": c, "z": z, "zc": np.concatenate([z, c], 1)}[emit])
    return np.concatenate(outs), ex.pending_samples


@pytest.mark.parametrize("emit,chunk", [("zc", 16000), ("c", 777),
                                        ("z", 160)])
def test_f32_frames_equal_the_extractor(workdir, emit, chunk):
    wave = (np.random.default_rng(7).standard_normal(9000) * 0.2
            ).astype("<f4")
    raw, lines = _run(["--workdir", str(workdir), "--emit", emit,
                       "--chunk-samples", str(chunk), "--device", "cpu"],
                      wave.tobytes())
    want, pending = _reference(_extractor(workdir), wave, chunk, emit)
    dim = {"c": 16, "z": 16, "zc": 32}[emit]
    frames = np.frombuffer(raw, "<f4").reshape(-1, dim)
    np.testing.assert_array_equal(frames, want)
    header, summary = lines[0], lines[-1]
    assert header == {"emit": emit, "frame_dim": dim,
                      "frame_stride_samples": 160,
                      "receptive_field_samples": 465, "d_enc": 16,
                      "d_ar": 16}
    assert summary == {"frames": (9000 - 465) // 160 + 1,
                       "dropped_tail_samples": pending,
                       "dropped_partial_bytes": 0}
    assert pending == 9000 - summary["frames"] * 160


def test_i16_stdin_equals_f32_of_the_dequantized_samples(workdir):
    q = np.random.default_rng(11).integers(-3000, 3000, 5001,
                                           dtype=np.int16)
    raw_i, lines = _run(["--workdir", str(workdir), "--in-format", "i16",
                         "--stats", "0.0", "0.1", "--device", "cpu"],
                        q.astype("<i2").tobytes() + b"\x01")
    deq = (q.astype(np.float32) / 32768.0).astype("<f4")
    raw_f, _ = _run(["--workdir", str(workdir), "--stats", "0.0", "0.1",
                     "--device", "cpu"], deq.tobytes())
    assert raw_i == raw_f and len(raw_i) > 0
    assert lines[-1]["dropped_partial_bytes"] == 1
    want, _ = _reference(_extractor(workdir, stats=(0.0, 0.1)), deq, 16000,
                         "c")
    np.testing.assert_array_equal(np.frombuffer(raw_i, "<f4").reshape(-1, 16),
                                  want)


@pytest.mark.parametrize("fmt", ["f32", "i16"])
def test_to_f32_matches_jax(fmt):
    raw = np.random.default_rng(3).integers(0, 256, 4099,
                                            dtype=np.uint8).tobytes()
    for carry in (b"", b"\x05"):
        x, rest = serve._to_f32(raw, fmt, carry)
        jx, jrest = jserve._to_f32(raw, fmt, carry)
        np.testing.assert_array_equal(x, jx)
        assert x.dtype == np.float32 and rest == jrest


def test_header_and_summary_equal_the_jax_server(workdir, monkeypatch):
    # the JAX server's own main around a stand-in for its live stream that
    # serves the port's frames: its stdout and stderr must equal the port's
    ex = _extractor(workdir)

    class Stream:
        down, rf, d_enc, d_ar = ex.down, ex.rf, 16, 16
        push = staticmethod(ex.push)

        @property
        def pending_samples(self):
            return ex.pending_samples

    monkeypatch.setattr(jserve, "_LiveStream", lambda workdir, stats: Stream())
    wave = (np.random.default_rng(5).standard_normal(4321) * 0.2
            ).astype("<f4")
    argv = ["--workdir", str(workdir), "--emit", "zc", "--chunk-samples",
            "1001"]
    out, err = io.BytesIO(), io.StringIO()
    assert jserve.main(argv, stdin=io.BytesIO(wave.tobytes()), stdout=out,
                       stderr=err) == 0
    raw, lines = _run([*argv, "--device", "cpu"], wave.tobytes())
    assert lines == [json.loads(line) for line in err.getvalue().splitlines()]
    assert raw == out.getvalue() and len(raw) > 0


def test_info_prints_the_header_and_exits(workdir):
    raw, lines = _run(["--workdir", str(workdir), "--info", "--emit", "z",
                       "--device", "cpu"], b"\x00" * 640)
    assert raw == b"" and len(lines) == 1
    assert lines[0]["frame_dim"] == 16 and lines[0]["emit"] == "z"


def test_flag_errors(workdir, tmp_path):
    def main(argv):
        return serve.main(argv, stdin=io.BytesIO(b""), stdout=io.BytesIO(),
                          stderr=io.StringIO())

    with pytest.raises(SystemExit):   # --stats is a workdir-mode flag
        main(["--artifact", "a.stream", "--stats", "0", "1"])
    with pytest.raises(SystemExit):
        main(["--workdir", str(workdir), "--chunk-samples", "0"])
    with pytest.raises(SystemExit):   # one source, not both
        main(["--workdir", str(workdir), "--artifact", "a.stream"])
    with pytest.raises(FileNotFoundError):   # the artifact backend loads
        main(["--artifact", str(tmp_path / "a.pt2"), "--device", "cpu"])
    # a workdir with a config but no weights exits; one with no config too
    (tmp_path / "config.json").write_text(
        (workdir / "config.json").read_text())
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(["--workdir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no persisted config"):
        main(["--workdir", str(tmp_path / "none"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--workdir", str(workdir)])


def test_module_entry_point(workdir):
    import subprocess
    import sys
    from pathlib import Path
    wave = (np.random.default_rng(1).standard_normal(1000) * 0.2
            ).astype("<f4")
    proc = subprocess.run(
        [sys.executable, "-m", "cpc_tpu_torch.serve", "--workdir",
         str(workdir), "--device", "cpu"], input=wave.tobytes(),
        capture_output=True, cwd=Path(__file__).resolve().parent.parent,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stderr.decode().splitlines()]
    frames = lines[-1]["frames"]
    assert frames == (1000 - 465) // 160 + 1
    assert len(proc.stdout) == frames * 16 * 4
