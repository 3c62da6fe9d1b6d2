"""The harness is driven by files: a copy of h100_bench/ with one more
workload (a BENCHMARK.json entry and its traffic and limits files), one
more configuration file, one more per-layer metric, stage and counting
file lists and parses them with no other file of the copy changed."""

import json
import shutil

from h100_bench import spec

NEW = "tpu_fast_k8.train_b32"


def test_added_files_are_found(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    here = tmp_path / "h100_bench"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}

    conf = json.loads((here / "configs" / "tpu_fast.json").read_text())
    conf["name"] = "tpu_fast_k8"
    conf["config"]["model"]["loss"]["prediction_steps"] = 8
    (here / "configs" / "tpu_fast_k8.json").write_text(json.dumps(conf))
    traffic = json.loads((here / "traffic" / "train_b64.json").read_text())
    (here / "traffic" / "train_b32.json").write_text(
        json.dumps(dict(traffic, batch_size=32)))
    (here / "limits" / f"{NEW}.json").write_text(json.dumps(
        {"loss_gap": 0.5}))
    (here / "metrics" / "steps_seen.py").write_text(
        "def read(rec):\n    return float(rec.steps)\n")
    (here / "stages" / "zz_new.json").write_text(json.dumps(
        {"priority": 1, "what": "a new kernel", "patterns": ["NewKernel"]}))
    (here / "counts" / "extra.py").write_text(
        "def applies(d):\n    return True\n\n"
        "def forward(d):\n    return None\n\n"
        "def backward(d):\n    return None\n\n"
        "def model_flops(d):\n    return 1.0\n")
    bench["configs"].append({"name": "tpu_fast_k8", "source": "x",
                             "file": "h100_bench/configs/tpu_fast_k8.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": NEW, "config": "tpu_fast_k8",
                               "traffic": "train_b32", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "audio_s_per_s",
                               "workloads": [NEW]})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append(NEW)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(NEW, base=tmp_path)
    assert cell.config["config"]["model"]["loss"]["prediction_steps"] == 8
    assert cell.traffic["batch_size"] == 32
    assert cell.limits == {"loss_gap": 0.5}
    assert [m["name"] for m in cell.end_to_end] == ["audio_s_per_s",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["steps_seen"]
    reader = spec.readers(["steps_seen"], base=tmp_path)["steps_seen"]
    assert reader.read(type("R", (), {"steps": 7})()) == 7.0
    assert spec.stages(base=tmp_path)[0]["name"] == "zz_new"
    assert "extra" in spec.count_modules(base=tmp_path)
    # the old cells still load, and no file that was there changed
    assert spec.load_cell("tpu_fast.train_b64", base=tmp_path).name == \
        "tpu_fast.train_b64"
    for p, data in before.items():
        assert p.read_bytes() == data, p
