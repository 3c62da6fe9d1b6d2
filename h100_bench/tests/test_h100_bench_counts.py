"""The counting functions reproduce PERF.md's kernel table's bounds
(bf16 at 989 TFLOP/s, 3.35 TB/s) at its rows' shapes, and the per-step
model operations behind mfu match counts made by hand."""

import copy

import pytest

from h100_bench import roofline, spec
from h100_bench.dims import dims, latents

PEAK = spec.peaks("NVIDIA H100 80GB HBM3")
PARTS = spec.count_modules()


def _files(cell):
    c = spec.load_cell(cell)
    return c.config, c.traffic


def _one_layer(d):
    """`d` with a one-layer gar: the table times one attention call."""
    model = copy.deepcopy(d["model"])
    model["ar"]["num_layers"] = 1
    return dict(d, model=model)


TPU_FAST = dims(*_files("tpu_fast.train_b64"))
T1024 = dims(*_files("transformer_fast_flash16.train_t1024"))
SHAPES = {"tpu_fast": TPU_FAST, "t1024": T1024,
          "flash1024": _one_layer(T1024),
          "flash128": _one_layer(dict(T1024, B=64, S=20480, T=128, C=64))}


def ms(work):
    return roofline.bound_s(work, PEAK) * 1e3


@pytest.mark.parametrize("part, half, shape, bound_ms", [
    ("conv1d", "forward", "tpu_fast", 0.4022),   # row 7
    ("gru", "forward", "tpu_fast", 0.0051),      # row 1
    ("gru", "backward", "tpu_fast", 0.0103),     # row 2
    ("heads", "forward", "tpu_fast", 0.0329),    # row 3
    ("heads", "backward", "tpu_fast", 0.0678),   # row 4
    ("flash", "forward", "flash128", 0.0051),    # row 10
    ("flash", "backward", "flash128", 0.0089),   # row 11
    ("flash", "forward", "flash1024", 0.0102),
    ("flash", "backward", "flash1024", 0.0217),
    ("heads", "forward", "t1024", 0.0658),
    ("heads", "backward", "t1024", 0.1357),
    ("conv1d", "forward", "t1024", 0.8045),
])
def test_bound_matches_the_kernel_table(part, half, shape, bound_ms):
    d = SHAPES[shape]
    assert PARTS[part].applies(d)
    assert ms(getattr(PARTS[part], half)(d)) == pytest.approx(bound_ms,
                                                              abs=6e-5)


def test_dims_of_the_cells():
    d = TPU_FAST
    assert {k: d[k] for k in ("B", "S", "T", "C", "K", "D", "A")} == \
        dict(B=64, S=20480, T=128, C=64, K=12, D=512, A=256)
    d = dims(*_files("dp_global_negatives.train_4card"))
    assert (d["world"], d["B"], d["C"]) == (4, 64, 256)
    d = T1024
    assert (d["B"], d["T"], d["model"]["ar"]["kind"],
            d["model"]["ar"]["attn_impl"]) == (16, 1024, "transformer",
                                                "flash16")


def test_parts_follow_the_model_section():
    """A counting module reads the model section that dims passes through:
    other negatives leave the same-step heads out of mfu, the unfused path
    leaves their kernel bound undefined, and an encoder no module knows
    has no latents."""
    model = copy.deepcopy(TPU_FAST["model"])
    model["loss"]["fuse_heads"] = False
    unfused = dict(TPU_FAST, model=model)
    assert PARTS["heads"].applies(unfused)
    assert PARTS["heads"].forward(unfused) is None
    assert PARTS["heads"].backward(unfused) is None
    assert roofline.step_model_flops(PARTS.values(), unfused) == \
        roofline.step_model_flops(PARTS.values(), TPU_FAST)
    model = copy.deepcopy(TPU_FAST["model"])
    model["loss"]["negatives"] = "all_steps"
    assert not PARTS["heads"].applies(dict(TPU_FAST, model=model))
    model = copy.deepcopy(TPU_FAST["model"])
    model["encoder"]["kind"] = "scalogram"
    with pytest.raises(KeyError, match="scalogram"):
        latents(model, 20480, PARTS)


def test_every_metric_has_a_reader():
    """Each metric of BENCHMARK.json reads through metrics/<name>.py or,
    without one, through the file of its name up to the first dot."""
    import json
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for n in names:
        assert spec.reader_path(n).exists(), n
    assert spec.reader_path("audio_s_per_s.t1024").name == "audio_s_per_s.py"
    assert spec.reader_path("idle_share.dp").name == "idle_share.dp.py"
    assert set(spec.readers(names)) == set(names)


def test_model_operations_tpu_fast():
    T, B, Tp = 128, 64, 116
    conv = 2 * B * (4096 * 10 * 1 * 512 + 1024 * 8 * 512 * 512
                    + 512 * 4 * 512 * 512 + 256 * 4 * 512 * 512
                    + 128 * 4 * 512 * 512)
    gru = 2 * T * B * 512 * 768 + 2 * T * B * 256 * 768
    heads = 2 * Tp * B * 256 * 12 * 512
    scores = 2 * Tp * 12 * B * 64 * 512
    want = 3 * (conv + gru + heads + scores)
    got = roofline.step_model_flops(PARTS.values(), TPU_FAST)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(1.3100e12, rel=1e-4)


def test_model_operations_transformer_t1024():
    B, T, Tp, A = 16, 1024, 1012, 256
    conv = 2 * (2 * 64 * (4096 * 10 * 1 * 512 + 1024 * 8 * 512 * 512
                          + 512 * 4 * 512 * 512 + 256 * 4 * 512 * 512
                          + 128 * 4 * 512 * 512))
    in_proj = 2 * B * T * 512 * A
    layer = (4 * 2 * B * T * A * A + 2 * 2 * B * T * A * 4 * A
             + 2 * 2 * 32 * (T * (T + 1) // 2) * B * 8)
    heads = 2 * Tp * B * A * 12 * 512 + 2 * Tp * 12 * B * 16 * 512
    want = 3 * (conv + in_proj + 2 * layer + heads)
    assert roofline.step_model_flops(PARTS.values(), T1024) == \
        pytest.approx(want, rel=1e-12)


def test_model_operations_dp_rank():
    """One rank of the DP cell: 64 rows scored against a pool of 256."""
    d = dims(*_files("dp_global_negatives.train_4card"))
    T, B, Tp = 128, 64, 116
    one = roofline.step_model_flops(PARTS.values(), dict(TPU_FAST))
    extra = 3 * 2 * Tp * 12 * B * (256 - 64) * 512
    assert roofline.step_model_flops(PARTS.values(), d) == \
        pytest.approx(one + extra, rel=1e-12)


def test_roofline_share_cannot_pass_its_bound():
    """A layer whose kernels take exactly its bound reads 100 %."""
    from h100_bench.harness import Record
    from h100_bench.metrics._layer import roofline_share
    from h100_bench.trace import TraceSummary

    bound = roofline.layer_bound_s([PARTS["gru"]], TPU_FAST, PEAK)
    tr = TraceSummary(steps=10, window_s=1.0, busy_s=0.5, busy_s_without={},
                      stage_s={"gru": 10 * bound}, span_s={}, gaps=[],
                      top_ops=[])
    rec = Record(dims=TPU_FAST, setup_s=0, window_s=1, steps=10,
                 audio_per_step=1, peak=PEAK, parts=PARTS, trace=tr)
    assert roofline_share(rec, "gru", "gru") == pytest.approx(100.0)


def test_roofline_share_is_silent_without_a_bound():
    """The unfused heads count no kernel function: their share reads None,
    never 0."""
    from h100_bench.harness import Record
    from h100_bench.metrics._layer import roofline_share
    from h100_bench.trace import TraceSummary

    model = copy.deepcopy(TPU_FAST["model"])
    model["loss"]["fuse_heads"] = False
    d = dict(TPU_FAST, model=model)
    tr = TraceSummary(steps=10, window_s=1.0, busy_s=0.5, busy_s_without={},
                      stage_s={"heads": 0.01}, span_s={}, gaps=[],
                      top_ops=[])
    rec = Record(dims=d, setup_s=0, window_s=1, steps=10, audio_per_step=1,
                 peak=PEAK, parts=PARTS, trace=tr)
    assert roofline_share(rec, "heads", "heads") is None
