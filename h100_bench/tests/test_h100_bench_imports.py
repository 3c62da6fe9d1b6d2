"""What a run may load: the reference imports nothing of JAX, of the JAX
package or of the port; a whole cell's run loads the port and nothing of
JAX; names compare whole before the first dot, since the port's name
begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from h100_bench import harness

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ["reference.py", "inputs.py", "check.py",
             "model/encoder_conv1d.py", "model/gar_gru.py", "model/gar_transformer.py",
             "model/loss_same_step.py"]
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "cpc_tpu",
          "cpc_tpu_torch"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; "
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_reference_imports_nothing_banned():
    tops = _loaded("import h100_bench.reference, h100_bench.inputs, "
                   "h100_bench.check")
    assert not tops & BANNED, tops & BANNED


def test_reference_sources_name_nothing_banned():
    for name in REFERENCE:
        tree = ast.parse((ROOT / "h100_bench" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert not {m.split(".")[0] for m in mods} & BANNED, (name, mods)


def test_whole_names_compare():
    assert harness.forbidden_modules(["cpc_tpu_torch.train", "torch"]) == []
    assert harness.forbidden_modules(["cpc_tpu.ops", "jax.numpy",
                                      "jaxlib", "flaxen"]) == \
        ["cpc_tpu", "jax", "jaxlib"]


def test_a_cell_run_loads_the_port_and_no_jax():
    code = ("import torch; torch.set_num_threads(1)\n"
            "from h100_bench import harness\n"
            "from h100_bench.tests.conftest import tiny_cell\n"
            "harness.run(tiny_cell('tpu_fast.train_b64'), 5, 0.5, False, "
            "t_start=0.0, device='cpu')")
    tops = _loaded(code)
    assert "cpc_tpu_torch" in tops
    assert not tops & (BANNED - {"cpc_tpu_torch"}), tops & BANNED


def test_the_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "h100_bench.run",
                          "--workload", "tpu_fast.train_b64", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
