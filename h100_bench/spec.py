"""Finds a cell's files by the names in BENCHMARK.json.

A cell (`workloads` entry) names a configuration and a traffic mix; the
harness reads `configs/<config>.json` (through the entry's `file`),
`traffic/<traffic>.json` and `limits/<cell>.json`. Each metric is a reader
`metrics/<name>.py`; a metric `<base>.<suffix>` without a file of its own
(a name kept apart so that one cell's spread does not widen another's
bound) reads as `<base>` does. Each device stage a pattern file `stages/<stage>.json`,
and each part of the model a counting module `counts/<part>.py`. Adding a
cell, a configuration, a metric, a stage or a part adds files; none of
these lists is written in code.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    limits: dict        # limits/<cell>.json
    end_to_end: List[dict]   # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def _applies(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """A per-layer metric is read in the cells its `workloads` lists, else
    in every cell that reports the end-to-end metric it `moves` (the
    meaning BENCHMARK.json gives a metric without `workloads`, which a
    later one may be)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, base: Path = ROOT) -> Cell:
    """The cell `name` of `base`/BENCHMARK.json with its files."""
    bench = load_json(base / "BENCHMARK.json")
    here = base / "h100_bench"
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has "
                       f"{[w['name'] for w in bench['workloads']]})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    traffic = here / "traffic" / f"{entry['traffic']}.json"
    return Cell(name=name, chips=entry["chips"], config_name=conf["name"],
                config=load_json(base / conf["file"]),
                traffic=load_json(traffic),
                limits=load_json(here / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def reader_path(name: str, base: Path = ROOT) -> Path:
    """metrics/<name>.py, else metrics/<name up to its first dot>.py."""
    here = base / "h100_bench" / "metrics"
    own = here / f"{name}.py"
    return own if own.exists() else here / f"{name.split('.')[0]}.py"


def readers(names: List[str], base: Path = ROOT) -> Dict[str, object]:
    """name -> its reader module (`reader_path`), whose read(record) gives
    the metric's value or None."""
    return {n: _module(reader_path(n, base)) for n in names}


def stages(base: Path = ROOT) -> List[dict]:
    """Every stages/*.json, in the order their patterns are tried
    (priority, then name): {"name", "priority", "patterns"}."""
    out = []
    for path in sorted((base / "h100_bench" / "stages").glob("*.json")):
        s = load_json(path)
        out.append({"name": path.stem, "priority": s["priority"],
                     "patterns": [p.lower() for p in s["patterns"]]})
    return sorted(out, key=lambda s: (s["priority"], s["name"]))


def count_modules(base: Path = ROOT) -> Dict[str, object]:
    """part -> counts/<part>.py."""
    return {p.stem: _module(p)
            for p in sorted((base / "h100_bench" / "counts").glob("*.py"))
            if not p.stem.startswith("_")}


def peaks(kind: str, base: Path = ROOT) -> Optional[dict]:
    """The published peaks of the card named `kind`, or None."""
    return load_json(base / "h100_bench" / "peaks.json").get(kind)
