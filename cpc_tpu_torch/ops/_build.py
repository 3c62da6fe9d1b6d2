"""Builds the port's CUDA kernels at first use and loads them with ctypes.

`csrc/*.cu` are compiled by `nvcc` for Hopper (`sm_90a`), one `nvcc` per
source, all started together, and linked into one shared library with a
plain C interface, under `build/kernels/` at the root of the checkout,
keyed by a hash of the sources and flags: an unchanged tree reuses its
library, a changed one builds anew. The sources include no PyTorch header,
so a build takes seconds (against minutes for
`torch.utils.cpp_extension.load`). nvcc's messages, with ptxas's register
and shared-memory report, go to `<library>.log`. Pointers and the stream
cross as Python ints. A missing `nvcc` or a failed build raises.

Nothing here runs at import: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build cpc_tpu_torch/csrc")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"cpc_kernels-{h.hexdigest()[:16]}.so"


def _run(procs):
    """Waits for every (cmd, Popen); returns their output, raises on the
    first failure."""
    log = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log[-1]}")
    return log


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def build() -> Path:
    """Compiles csrc/*.cu unless the library for these sources exists.
    Returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    try:
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            objs.append(obj)
            procs.append(_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                 str(src)]))
        log = _run(procs)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log += _run([_start([nvcc, "-shared", "-gencode",
                             "arch=compute_90a,code=sm_90a", "-o", str(tmp),
                             *map(str, objs)])])
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
        for stale in BUILD_DIR.glob(f"{out.stem}.{os.getpid()}.tmp"):
            stale.unlink()
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call, with every C
    function's signature declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    operand = [ptr, i64, i64, i64]  # a tensor and three of its strides
    attn_tail = [i32] * 4 + [ctypes.c_float] + [i32] * 3 + [ptr]
    plan = ctypes.POINTER(i32)  # a launch plan, ints
    i64s = ctypes.POINTER(i64)  # a leaf table's addresses or counts
    f32 = ctypes.c_float
    signatures = {
        "gru_scan_fwd": [ptr] * 5 + [i32] * 6 + [ptr],
        "gru_scan_bwd": [ptr] * 14 + [i32] * 7 + [ptr],
        "gru_exchange_probe": [ptr] + [i32] * 4 + [ptr],
        "heads_nll_fwd": [ptr] * 5 + [i32] * 9 + [ptr],
        "heads_nll_bwd": [ptr] * 7 + [i32] * 10 + [ptr],
        "same_step_nll_fwd": [ptr] * 5 + [i32] * 6 + [i64] * 4 + [i32] * 3
        + [ptr],
        "same_step_nll_bwd": [ptr] * 8 + [i32] * 6 + [i64] * 4 + [i32] * 3
        + [ptr],
        "allsteps_nll_fwd": [ptr] * 5 + [i32] * 6 + [i64] * 2 + [i32] * 3
        + [ptr],
        "allsteps_nll_bwd": [ptr] * 8 + [i32] * 6 + [i64] * 2 + [i32] * 4
        + [ptr],
        "gru_scan_max_hidden": [],
        "flash_attn_fwd": operand * 3 + [ptr] * 2 + attn_tail,
        "flash_attn_bwd": operand * 4 + [ptr] * 6 + [i32] + attn_tail,
        "flash_attn_empty": [i32] * 4 + [ptr],
        "flash_attn_launch_shape": [i32] * 6 + [ptr],
        "flash_attn_dq": operand * 4 + [ptr] * 3 + attn_tail,
        "flash_attn_dkv": operand * 4 + [ptr] * 4 + attn_tail,
        "conv_pyramid_layer": [ptr] * 4 + [i32] * 9 + [plan, i32, i32, ptr],
        "conv_pyramid_fused": [ptr] * 6 + [i32] * 13 + [plan, i32, i32, ptr],
        "adam_multi_sumsq": [i64s, i64s, plan, i32, i32, ptr, i32, ptr],
        "adam_multi_norm": [ptr, i32, ptr, i32, ptr],
        "adam_multi_update": [i64s] * 5 + [plan, i32, ptr, ptr] + [f32] * 7
        + [i32] * 3 + [ptr],
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32
    lib.cpc_error_string.argtypes = [i32]
    lib.cpc_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raises if a C entry point returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.cpc_error_string(err).decode()}")
