"""The program's spans in a traced window (`h100_bench/program_trace.py`), on
a synthetic Chrome trace: kernels, a copy, runtime launches with
correlation ids (one from another thread, one a graph's), the harness's
spans and the program's nested in them. Self time, launches and device
seconds by span; the window, busy time, stages and every existing metric
reader the same with and without the program's spans."""

import json
import time

import pytest
import torch

from cpc_tpu_torch.utils import profiling
from h100_bench import harness, spec
from h100_bench.dims import dims as cell_dims
from h100_bench.program_trace import (NO_SPAN, ProgramTracer,
                                      summarize_program)
from h100_bench.trace import summarize

MAIN, AUTOGRAD = 7, 9
HARNESS = [(0.0, 5.0, "feed"), (5.0, 10.0, "stage"), (12.0, 90.0, "step"),
           (92.0, 95.0, "agree")]
PROGRAM = [
    (-2.0, 6.0, "trainer.feed", MAIN),  # opened before the window: left out
    (4.0, 11.0, "trainer.stage", MAIN),
    (11.0, 91.0, "trainer.step", MAIN),
    (14.0, 40.0, "step.forward", MAIN),
    (40.0, 60.0, "step.backward", MAIN),
    (61.0, 88.0, "step.optimizer", MAIN),
    (62.0, 64.0, "step.scalars", MAIN),
    (91.5, 95.5, "trainer.agree", MAIN),
]


def _call(name, ts, corr, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 0.5, "pid": 1, "tid": tid, "args": {"correlation": corr}}


def _op(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


EVENTS = [
    _call("cudaLaunchKernel", 15.0, 1),
    _call("cudaLaunchKernel", 20.0, 2),
    _call("cudaLaunchKernel", 45.0, 3, tid=AUTOGRAD),
    _call("cudaMemcpyAsync", 63.0, 4),
    _call("cudaLaunchKernel", 70.0, 5),
    _call("cudaGraphLaunch", 80.0, 6),
    _call("cudaLaunchKernel", 96.0, 7),
    _call("cudaStreamSynchronize", 98.0, 8),
    _op("cudnn::fprop_implicit_gemm", 16.0, 14.0, 1),
    _op("gru_fwd_resident_kernel", 30.0, 5.0, 2),
    _op("sm90_xmma_wgrad_conv", 46.0, 24.0, 3),
    _op("Memcpy HtoD (Pinned -> Device)", 64.0, 1.0, 4, cat="gpu_memcpy"),
    _op("multi_tensor_apply_kernel", 72.0, 8.0, 5),
    _op("heads_fwd_mma_kernel", 81.0, 4.0, 6),
    _op("elementwise_kernel", 85.0, 4.0, 6),
    _op("ncclDevKernel_AllReduce", 96.5, 2.5, 7),
    {"ph": "i", "cat": "cuda_runtime", "name": "marker", "ts": 50.0},
]
STEPS = 1


def _summaries():
    stages = spec.stages()
    plain = summarize(EVENTS, HARNESS, stages, STEPS)
    program = summarize_program(EVENTS, HARNESS, PROGRAM, stages, STEPS,
                                MAIN)
    return plain, program


def test_self_time_launches_and_device_seconds_by_span():
    _, got = _summaries()
    assert got.launches == {"step.forward": 2, "step.backward": 1,
                            "step.optimizer": 2, NO_SPAN: 1}
    want_device = {"step.forward": 19e-6, "step.backward": 24e-6,
                   "step.scalars": 1e-6, "step.optimizer": 16e-6,
                   NO_SPAN: 2.5e-6}
    assert got.device_s.keys() == want_device.keys()
    for k, v in want_device.items():
        assert got.device_s[k] == pytest.approx(v), k
    assert (got.kernels, got.kernels_joined) == (7, 6)
    want_self = {"trainer.step": 80 - 73, "step": 78 - 73,
                 "step.optimizer": 27 - 2, "step.scalars": 2,
                 "step.forward": 26, "step.backward": 20,
                 "trainer.stage": 7, "stage": 5, "feed": 5,
                 "trainer.agree": 4, "agree": 3}
    assert got.self_s.keys() == want_self.keys()  # trainer.feed left out
    for k, v in want_self.items():
        assert got.self_s[k] == pytest.approx(v * 1e-6), k
    assert got.span_s["step.optimizer"] == pytest.approx(27e-6)
    # each idle gap goes to the innermost span, the program's where it is
    gaps = {name for name, *_ in got.gaps}
    assert gaps <= {"feed", "stage", "trainer.stage", "step.forward",
                    "step.backward", "step.optimizer", "step.scalars",
                    "trainer.step", "agree", "trainer.agree", NO_SPAN}
    assert "step" not in gaps and "step.optimizer" in gaps


def test_the_harness_window_and_every_reader_stay_as_they_were():
    plain, program = _summaries()
    assert (plain.window_s, plain.busy_s, plain.busy_s_without,
            plain.stage_s, plain.steps, plain.top_ops) == \
        (program.window_s, program.busy_s, program.busy_s_without,
         program.stage_s, program.steps, program.top_ops)
    for name, s in plain.span_s.items():
        assert program.span_s[name] == s, name
    names = []
    for cell_name in spec.load_json(spec.ROOT / "BENCHMARK.json")[
            "workloads"]:
        cell = spec.load_cell(cell_name["name"])
        names = [m["name"] for m in cell.per_layer + cell.end_to_end]
        readers = spec.readers(names)
        recs = [harness.Record(
            dims=cell_dims(cell.config, cell.traffic), setup_s=1.0,
            window_s=2.0, steps=STEPS, audio_per_step=1.0,
            peak=spec.peaks("NVIDIA H100 80GB HBM3"),
            parts=spec.count_modules(), trace=t) for t in (plain, program)]
        read = [{n: readers[n].read(r) for n in names} for r in recs]
        assert read[0] == read[1], cell.name
        assert any(v is not None for v in read[0].values())
    assert names


class _FakeProfiler:
    """Stands in for torch.profiler on the CPU: its trace holds one kernel
    that runs from its start to its stop."""

    def start(self):
        self.t0 = time.time_ns()

    def stop(self):
        self.t1 = time.time_ns()

    def export_chrome_trace(self, path):
        op = _op("gemm", 0.0, (self.t1 - self.t0) / 1e3, 1)
        with open(path, "w") as f:
            json.dump({"baseTimeNanoseconds": self.t0, "traceEvents": [
                _call("cudaLaunchKernel", 1.0, 1), op]}, f)


@pytest.mark.parametrize("recorder", [True, False])
def test_the_tracer_records_the_programs_spans_of_the_traced_steps(
        monkeypatch, recorder):
    import h100_bench.program_trace as pt
    if not recorder:  # a program from before the recorder
        monkeypatch.setattr(pt, "_recorder", lambda: None)
    monkeypatch.setattr(ProgramTracer, "_profile",
                        staticmethod(_FakeProfiler))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    tracer = ProgramTracer(1, 1, spec.stages())
    for i in range(3):
        tracer.before(i)
        with tracer.span("step"), profiling.span("step.forward"):
            time.sleep(0.001)
        tracer.after(i)
    got = tracer.summary
    assert got.steps == 1 and got.span_s["step"] > 0
    if recorder:
        assert 0 < got.span_s["step.forward"] <= got.span_s["step"]
        assert got.self_s["step"] == pytest.approx(
            got.span_s["step"] - got.span_s["step.forward"])
    else:
        assert "step.forward" not in got.span_s
    with pytest.raises(RuntimeError, match="not being recorded"):
        profiling.take_spans()  # the tracer stopped the recorder
