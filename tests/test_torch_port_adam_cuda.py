"""The optimizer's kernel pair (`ops/adam_cuda.py`, `csrc/adam_multi.cu`) and
the path `train/train_step.py::Optimizer` chooses.

On the CPU: the launch planner covers every element of every leaf once, in
leaf order, within CUDA's 4 KB of kernel parameters, over several launches
where the table needs them, with the source's limits; the CPU takes the
tensor code (fp32, a bf16 leaf, a strided gradient) and a leaf table
refuses CPU leaves; a train step with the clip on takes the global norm
once, and a step takes the norm its caller passes, else its own
gradients'; the kernels' names fall in the benchmark's stage `rest`
(`h100_bench/stages/*.json`, read, not edited).

Marked `cuda` and skipped without a GPU: the fused step against the tensor
code over 6 steps on the leaves of `tpu_fast` and `transformer_fast`, bit
for bit on params, mu and nu given the same norm (Adam, the clip firing and
idle, AdamW with a cosine schedule, warm-up's lr 0); the fused norm within
1e-6 of `global_norm`; two runs bit-equal; odd lengths, addresses off 16
bytes and a table of two launches; the card refusing a bf16 leaf, a bf16
or strided gradient; a train step's one launch of each kernel. The card's
tests import no jax:

    python -m pytest tests/test_torch_port_adam_cuda.py -q -m cuda \\
        --noconftest
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.ops import adam_cuda
from cpc_tpu_torch.ops.adam_cuda import (CHUNK, FIXED_BYTES, LEAF_BYTES,
                                         MAX_LEAVES, PARAM_BYTES,
                                         plan_launches)
from cpc_tpu_torch.train import train_step as ts
from cpc_tpu_torch.train.train_step import (Optimizer, global_norm,
                                            init_state, make_step_fns)

SOURCE = Path(adam_cuda.__file__).resolve().parent.parent / "csrc" / \
    "adam_multi.cu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors: one intra-op thread, so that the tier-1 run's workers
    # do not oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the planner
def _blocks(plan):
    """(leaf, lo, hi) of every block of every launch, in launch and block
    order, as the kernels read the plan (csrc/adam_multi.cu::leaf_of)."""
    out = []
    for launch in plan:
        starts = launch.block_starts
        for b in range(starts[-1]):
            j = max(j for j in range(len(launch.leaves)) if starts[j] <= b)
            out.append((launch.leaves[j], (b - starts[j]) * CHUNK))
    return out


@pytest.mark.parametrize("numels", [
    [1], [CHUNK], [CHUNK + 1], [0], [0, 5, 0, 3 * CHUNK + 7, 1],
    [4] * MAX_LEAVES, [4] * (MAX_LEAVES + 1),
    [(i * 7919) % (3 * CHUNK) for i in range(200)],
], ids=["one", "chunk", "chunk+1", "empty", "mixed", "full", "full+1",
        "200"])
def test_plan_covers_every_element_once_in_leaf_order(numels):
    plan = plan_launches(numels)
    live = [i for i, n in enumerate(numels) if n > 0]
    assert len(plan) == -(-len(live) // MAX_LEAVES)
    base = 0
    for launch in plan:
        assert 1 <= len(launch.leaves) <= MAX_LEAVES
        assert len(launch.leaves) * LEAF_BYTES + FIXED_BYTES <= PARAM_BYTES
        assert launch.block_base == base
        assert len(launch.block_starts) == len(launch.leaves) + 1
        base += launch.block_starts[-1]
    covered = {}
    order = []
    for leaf, lo in _blocks(plan):
        hi = min(lo + CHUNK, numels[leaf])
        assert lo < hi
        covered.setdefault(leaf, []).append((lo, hi))
        if not order or order[-1] != leaf:
            order.append(leaf)
    assert order == live  # each leaf's blocks together, leaves ascending
    for leaf in live:
        spans = covered[leaf]
        assert spans[0][0] == 0 and spans[-1][1] == numels[leaf]
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_the_parameter_space_holds_the_kernels_limit():
    src = SOURCE.read_text()
    assert f"kMaxLeaves = {MAX_LEAVES};" in src
    assert f"kChunk = {CHUNK};" in src


# ------------------------------------------------------- the path, on the CPU
def _leaves(seed=0, shapes=((3, 4), (5,), (2, 2, 2))):
    rng = np.random.default_rng(seed)
    return {f"l{i}": torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for i, s in enumerate(shapes)}


def test_takes_reads_dtype_layout_and_device():
    cpu = torch.device("cpu")
    a = torch.zeros(3, 4)
    assert adam_cuda.takes([a, a[1]], cpu)
    assert not adam_cuda.takes([a, a.bfloat16()], cpu)
    assert not adam_cuda.takes([a.T], cpu)
    assert not adam_cuda.takes([a, torch.zeros(3, device="meta")], cpu)
    assert not adam_cuda.takes([None], cpu)


@pytest.mark.parametrize("case", ["fp32", "bf16_leaf", "strided_grad"])
def test_the_cpu_takes_the_tensor_code(case):
    params = _leaves()
    if case == "bf16_leaf":
        params["l1"] = params["l1"].bfloat16()
    t = tcfg.TrainConfig(learning_rate=1e-2, grad_clip_norm=0.5)
    opt = Optimizer(params, t)
    assert opt.table is None
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    if case == "strided_grad":
        grads["l0"] = torch.ones(4, 3).T
    before = {k: p.clone() for k, p in params.items()}
    launched = _launches()
    opt.step(grads)
    assert _launches() == launched
    assert all(not torch.equal(before[k], p) for k, p in params.items())


def test_a_leaf_table_refuses_leaves_off_the_card():
    leaves = list(_leaves().values())
    with pytest.raises(ValueError, match="one CUDA device"):
        adam_cuda.LeafTable(leaves, leaves, leaves, b1=0.9, b2=0.999,
                            eps=1e-8, clip=0.0, weight_decay=0.0)


def _launches():
    return tuple(f.launches for f in (adam_cuda.adam_multi_sumsq,
                                      adam_cuda.adam_multi_norm,
                                      adam_cuda.adam_multi_update))


def _spy_norms(monkeypatch):
    calls = []
    inner = ts.global_norm

    def spy(tensors):
        calls.append(1)
        return inner(tensors)
    monkeypatch.setattr(ts, "global_norm", spy)
    return calls


TINY_SETS = ["model.encoder.channels=16,16,16,16,16", "model.encoder.d_enc=16",
             "model.ar.d_ar=16", "model.loss.prediction_steps=3",
             "data.batch_size=4", "data.snippet_samples=2560",
             "model.dtype=float32", "model.loss.pallas_bf16=false",
             "train.grad_clip_norm=0.01"]


@pytest.mark.parametrize("accum", [1, 2])
def test_a_clipped_step_takes_the_norm_once(monkeypatch, accum):
    cfg = tcfg.apply_overrides(tcfg.presets.tpu_fast(),
                               [*TINY_SETS, f"train.accum_steps={accum}"])
    steps = make_step_fns(cfg, init_state(cfg, "cpu"))
    batch = torch.from_numpy(np.clip(np.random.default_rng(1).standard_normal(
        (4, 2560)) * 6000, -32768, 32767).astype(np.int16))
    calls = _spy_norms(monkeypatch)
    metrics = steps.train_step(batch)
    assert len(calls) == 1
    assert metrics["grad_norm"] > cfg.train.grad_clip_norm  # the clip fired


def test_a_step_on_other_grads_takes_their_norm(monkeypatch):
    t = tcfg.TrainConfig(learning_rate=1e-2, grad_clip_norm=0.5)
    a, b, c = (Optimizer(_leaves(), t) for _ in range(3))
    g1, g2 = _leaves(1), _leaves(2)
    n1, n2 = (global_norm(g.values()) for g in (g1, g2))
    assert min(n1, n2) > t.grad_clip_norm  # the clip fires
    calls = _spy_norms(monkeypatch)
    a.step(g2)  # no norm passed: g2's own
    b.step(g2, norm=n2)
    c.step(g2, norm=n1)  # the caller's norm, whatever it is
    assert len(calls) == 1
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.mu[k], b.mu[k]), k
    assert not all(torch.equal(a.mu[k], c.mu[k]) for k in a.params)


def _kernel_names():
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)\s*\(", SOURCE.read_text())


def test_the_kernels_fall_in_stage_rest():
    from h100_bench import spec
    from h100_bench.trace import REST, classify

    names = _kernel_names()
    assert sorted(names) == ["adam_multi_norm_kernel",
                             "adam_multi_sumsq_kernel",
                             "adam_multi_update_kernel"]
    stages = spec.stages()
    for name in names:
        # as the profiler names them: demangled, with their parameters
        shown = (f"(anonymous namespace)::{name}((anonymous namespace)::"
                 f"Leaves, (anonymous namespace)::Hyper, float const*, "
                 f"float const*)")
        assert classify(name, stages) == REST, name
        assert classify(shown, stages) == REST, shown


# ---------------------------------------------------------------- the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


CARD_CASES = {
    "adam": {"learning_rate": 2e-4},
    "clip_fires_warmup": {"learning_rate": 1e-3, "grad_clip_norm": 0.5,
                          "warmup_steps": 3},
    "clip_idle": {"learning_rate": 1e-3, "grad_clip_norm": 1e9},
    "adamw_cosine": {"learning_rate": 1e-3, "weight_decay": 0.01,
                     "lr_schedule": "cosine", "warmup_steps": 2,
                     "num_steps": 6, "grad_clip_norm": 1.0},
}


def _preset_leaves(preset):
    cfg = getattr(tcfg.presets, preset)()
    return {k: p.detach().clone() for k, p in
            init_state(cfg, "cuda").named_parameters()}


def _offset(n, device, off=1, seed=0):
    """A contiguous fp32 tensor of n elements whose address is `off`
    elements past a 16-byte boundary."""
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(n + off, generator=gen, device=device)
    return buf[off:]


def _grads(params, step, scale=1.0, off=0):
    """Seeded gradients, each `off` elements past a 16-byte boundary."""
    return {k: _offset(p.numel(), p.device, off, seed=1000 * step + i)
            .view(p.shape).mul_(scale * (1 + i % 5))
            for i, (k, p) in enumerate(params.items())}


def _twins(params, t):
    """A fused optimizer and one held to the tensor code, on copies."""
    fused = Optimizer({k: p.clone() for k, p in params.items()}, t)
    plain = Optimizer({k: p.clone() for k, p in params.items()}, t)
    plain.table = None
    assert fused.table is not None
    return fused, plain


def _assert_bits(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), f"param {k}"
        assert torch.equal(a.mu[k], b.mu[k]), f"mu {k}"
        assert torch.equal(a.nu[k], b.nu[k]), f"nu {k}"


def _steps_in_twins(params, t, steps=6, scale=1e-3, off=0):
    fused, plain = _twins(params, t)
    norms = []
    for i in range(steps):
        grads = _grads(params, i, scale, off)
        assert all(g.data_ptr() % 16 == 4 * off for g in grads.values())
        norm = global_norm(grads.values())
        norms.append(norm.item())
        launched = _launches()
        fused.step(grads, norm=norm)  # the same norm on both sides
        assert _launches() == (launched[0], launched[1],
                               launched[2] + len(fused.table.plan))
        plain.step(grads, norm=norm)
        _assert_bits(fused, plain)
    return fused, norms


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tpu_fast", "transformer_fast"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_fused_step_equals_the_tensor_code_on_the_card(preset, case):
    _need_cuda()
    t = tcfg.TrainConfig(**CARD_CASES[case])
    params = _preset_leaves(preset)
    fused, norms = _steps_in_twins(params, t)
    if case == "clip_fires_warmup":
        assert min(norms) > t.grad_clip_norm
    if "clip" in case or case == "adamw_cosine":
        assert any(not torch.equal(fused.params[k], params[k])
                   for k in params)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tpu_fast", "transformer_fast"])
def test_fused_norm_is_global_norm_and_repeats_on_the_card(preset):
    _need_cuda()
    params = _preset_leaves(preset)
    opt = Optimizer(params, tcfg.TrainConfig())
    grads = _grads(params, 0)
    got = opt.norm(grads)
    want = global_norm(grads.values())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert torch.equal(opt.norm(grads), got)


@pytest.mark.cuda
def test_two_fused_runs_are_bit_equal_on_the_card():
    _need_cuda()
    params = _preset_leaves("transformer_fast")
    t = tcfg.TrainConfig(**CARD_CASES["adamw_cosine"])
    runs = []
    for _ in range(2):
        opt = Optimizer({k: p.clone() for k, p in params.items()}, t)
        for i in range(3):
            grads = _grads(params, i, 1e-3)
            opt.step(grads, norm=opt.norm(grads))
        runs.append(opt)
    _assert_bits(*runs)


@pytest.mark.cuda
@pytest.mark.parametrize("leaves", ["odd_and_unaligned", "two_launches"])
def test_odd_unaligned_and_long_tables_on_the_card(leaves):
    _need_cuda()
    dev = torch.device("cuda")
    if leaves == "odd_and_unaligned":
        sizes = [1, 3, 4, 4097, 2 * CHUNK + 5, CHUNK]
        params = {f"p{i}": _offset(n, dev, off=i % 3, seed=10_000 + i)
                  for i, n in enumerate(sizes)}
    else:
        sizes = [(i * 613) % 5000 + 1 for i in range(MAX_LEAVES + 13)]
        params = {f"p{i}": _offset(n, dev, off=0, seed=10_000 + i)
                  for i, n in enumerate(sizes)}
    assert any(p.data_ptr() % 16 for p in params.values()) == \
        (leaves == "odd_and_unaligned")
    t = tcfg.TrainConfig(**CARD_CASES["clip_fires_warmup"])
    off = int(leaves == "odd_and_unaligned")  # the gradients' offset
    fused, _ = _steps_in_twins(params, t, steps=3, scale=1.0, off=off)
    assert len(fused.table.plan) == (2 if leaves == "two_launches" else 1)
    grads = [_offset(p.numel(), dev, off, seed=7) for p in params.values()]
    torch.testing.assert_close(fused.table.norm(grads), global_norm(grads),
                               rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16_leaf", "strided_grad", "bf16_grad"])
def test_the_card_refuses_what_the_kernels_cannot_take(case):
    _need_cuda()
    params = {k: v.cuda() for k, v in _leaves().items()}
    t = tcfg.TrainConfig(learning_rate=1e-2, grad_clip_norm=0.5)
    if case == "bf16_leaf":
        params["l1"] = params["l1"].bfloat16()
        with pytest.raises(ValueError, match="contiguous float32"):
            Optimizer(params, t)
        return
    opt = Optimizer(params, t)
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    if case == "strided_grad":
        grads["l0"] = torch.ones(4, 3, device="cuda").T
    else:
        grads["l2"] = grads["l2"].bfloat16()
    before = {k: p.clone() for k, p in params.items()}
    launched = _launches()
    for call in (lambda: opt.norm(grads), lambda: opt.step(grads)):
        with pytest.raises(ValueError, match="contiguous float32"):
            call()
    assert _launches() == launched and opt.count == 0
    _assert_bits(opt, Optimizer(before, t))


@pytest.mark.cuda
def test_a_train_step_fuses_every_leaf_on_the_card(monkeypatch):
    _need_cuda()
    cfg = tcfg.apply_overrides(tcfg.presets.transformer_fast(), [
        *TINY_SETS, "model.ar.d_ar=16", "model.ar.num_heads=2",
        "model.ar.num_layers=1"])
    steps = make_step_fns(cfg, init_state(cfg, "cuda"))
    batch = torch.from_numpy(np.clip(np.random.default_rng(1).standard_normal(
        (4, 2560)) * 6000, -32768, 32767).astype(np.int16)).cuda()
    calls = _spy_norms(monkeypatch)
    launched = _launches()
    steps.train_step(batch)
    assert calls == []  # the norm came from the kernels
    assert len(steps.optimizer.table.plan) == 1
    # one sum of squares, its finishing launch and one update
    assert _launches() == tuple(n + 1 for n in launched)
