"""`make_multi_step` (`cpc_tpu_torch/train/train_step.py`): N training
steps in one call, a CUDA-graph replay on a card, the same steps one after
another on the CPU.

On the CPU: `multi` against N sequential `train_step` calls of a twin of
the model, bit for bit (rtol = atol = 0) in the parameters, Adam's moments,
the count and the loss, over two calls (the second reads the next rows of
the scalar table and re-seeds the generators): accum 1 and 2, a
transformer whose clip fires under warmup, augmentation, dropout, remat,
the all-steps loss and AdamW with a cosine schedule; and so while the
program's host spans record (`utils.profiling.record_spans`). Against the JAX
package's `make_multi_step` from the same weights (`from_jax_params`) at
`jax.default_matmul_precision('highest')`: the loss within
`test_torch_port_train_step.py`'s TOL["float32"], the parameters within
its Adam bound (2 lr a step on an entry whose gradient's sign the rounding
can flip, 1e-6 else). The refusals (ValueError), the optimizer and the
whole multi-step with `Tensor.__bool__` and `.item` made to raise (no host
read), and a checkpoint taken after a call resuming to the straight run.
Marked `cuda` and skipped without a GPU: the same comparisons through the
graph, bit for bit, also with the spans recording through the capture.

jax is imported inside the JAX comparison only, so that the `cuda` tests
run where jax is not installed:

    python -m pytest tests/test_torch_port_multi_step.py -q -m cuda \\
        --noconftest
"""

import socket

import numpy as np
import pytest
import torch

from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.parallel import multihost
from cpc_tpu_torch.parallel.mesh import thread_meshes
from cpc_tpu_torch.train.checkpoint import CheckpointManager
from cpc_tpu_torch.train.train_step import (Optimizer, global_norm,
                                            init_state, make_multi_step,
                                            make_step_fns)
from cpc_tpu_torch.utils.profiling import record_spans, take_spans

N = 3
TINY_SETS = ["model.encoder.channels=16,16,16,16,16", "model.encoder.d_enc=16",
             "model.ar.d_ar=16", "model.loss.prediction_steps=3",
             "data.batch_size=4", "data.snippet_samples=2560",
             "model.dtype=float32", "model.loss.pallas_bf16=false",
             "train.learning_rate=2e-3"]
TRANSFORMER_SETS = ["model.ar.d_ar=16", "model.ar.num_heads=2",
                    "model.ar.num_layers=1"]
CASES = {
    "accum1": ("tpu_fast", []),
    "accum2": ("tpu_fast", ["train.accum_steps=2"]),
    # the clip fires (grad_norm above 0.05) while the lr warms up
    "transformer_clip_warmup": ("transformer_fast", [
        *TRANSFORMER_SETS, "train.grad_clip_norm=0.05",
        "train.warmup_steps=4"]),
    "augment": ("tpu_fast", ["data.augment=true"]),
    "transformer_dropout_accum2": ("transformer_fast", [
        *TRANSFORMER_SETS, "model.ar.dropout=0.1", "train.accum_steps=2"]),
    "remat": ("transformer_fast", [*TRANSFORMER_SETS,
                                   "model.encoder.remat=true",
                                   "model.ar.remat=true"]),
    "all_steps_adamw_cosine": ("tpu_fast", [
        "model.loss.negatives=all_steps", "train.weight_decay=0.01",
        "train.lr_schedule=cosine", "train.warmup_steps=2",
        "train.num_steps=5"]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny tensors: one intra-op thread, so that the tier-1 run's workers
    # do not oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(preset="tpu_fast", sets=()):
    return tcfg.apply_overrides(getattr(tcfg.presets, preset)(),
                                [*TINY_SETS, *sets])


def _stacks(cfg, calls=2, seed=1, device="cpu"):
    B, S = cfg.data.batch_size, cfg.data.snippet_samples
    x = np.random.default_rng(seed).standard_normal((calls, N, B, S)) * 6000
    return torch.from_numpy(np.clip(x, -32768, 32767).astype(np.int16)
                            ).to(device)


def _state(model, opt):
    return ([(f"param {k}", p) for k, p in model.named_parameters()]
            + [(f"mu {k}", v) for k, v in opt.mu.items()]
            + [(f"nu {k}", v) for k, v in opt.nu.items()])


def _assert_equal(a, b):
    (model_a, opt_a), (model_b, opt_b) = a, b
    assert opt_a.count == opt_b.count
    for (k, x), (_, y) in zip(_state(model_a, opt_a), _state(model_b, opt_b)):
        assert torch.equal(x, y), k


def _multi_against_eager(cfg, device="cpu"):
    """Two calls of multi against 2 N eager steps of a twin, bit for bit;
    returns the eager steps' grad_norms."""
    ma, mb = init_state(cfg, device), init_state(cfg, device)
    multi, steps = make_multi_step(cfg, ma, N)
    eager = make_step_fns(cfg, mb)
    norms = []
    for stack in _stacks(cfg, device=device):
        loss = multi(stack)
        for batch in stack:
            metrics = eager.train_step(batch)
            norms.append(metrics["grad_norm"].item())
        assert torch.equal(loss, metrics["loss"])
        _assert_equal((ma, steps.optimizer), (mb, eager.optimizer))
    assert steps.optimizer.count == 2 * N
    return norms


@pytest.mark.parametrize("case", list(CASES))
def test_multi_equals_sequential_steps(case):
    preset, sets = CASES[case]
    cfg = _cfg(preset, sets)
    norms = _multi_against_eager(cfg)
    if case == "transformer_clip_warmup":
        assert max(norms) > cfg.train.grad_clip_norm  # the clip fired


def _multi_against_eager_recording(cfg, device="cpu"):
    """`_multi_against_eager` with the program's spans recording; the
    spans' names."""
    record_spans()
    try:
        _multi_against_eager(cfg, device)
    finally:
        names = {s[2] for s in take_spans()}
    return names


@pytest.mark.parametrize("case", ["accum2", "transformer_clip_warmup"])
def test_multi_equals_sequential_steps_while_spans_record(case):
    names = _multi_against_eager_recording(_cfg(*CASES[case]))
    assert {"step.forward", "step.backward", "step.optimizer",
            "step.scalars"} <= names


@pytest.mark.parametrize("accum", [1, 2])
def test_multi_matches_jax_make_multi_step(accum):
    import jax
    import jax.numpy as jnp
    from cpc_tpu import config as jcfg
    from cpc_tpu.models.cpc import CPCModel as JaxCPCModel
    from cpc_tpu.parallel.mesh import make_mesh
    from cpc_tpu.train.train_step import (
        make_multi_step as jax_make_multi_step)
    from cpc_tpu_torch.interop import from_jax_params
    from cpc_tpu_torch.models.cpc import CPCModel
    from test_torch_port_train_step import (BATCH, LR, SAMPLES, TOL,
                                            _batches, _cfg as jax_cfg,
                                            _params)

    cfg = jax_cfg("float32", accum)
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    jmulti, jsteps = jax_make_multi_step(cfg, JaxCPCModel(cfg.model), N,
                                         mesh)
    params = _params(cfg)
    stack = np.stack(_batches(N))
    tc = tcfg.from_dict(jcfg.to_dict(cfg))
    model = CPCModel(tc.model)
    model.load_state_dict(from_jax_params(params, tc))
    multi, _ = make_multi_step(tc, model, N)
    loss = multi(torch.from_numpy(stack))
    grad_fn = jax.jit(jax.grad(lambda p, b: jsteps.loss_fn(p, b)[0]))
    sens = {}
    with jax.default_matmul_precision("highest"):
        jp, _, jloss = jmulti(jax.tree.map(jnp.copy, params),
                               jsteps.optimizer.init(params),
                               jnp.asarray(stack))
        # each entry's sensitivity to a gradient error along JAX's steps,
        # as test_torch_port_train_step.py bounds the parameters
        p, s = params, jsteps.optimizer.init(params)
        for batch in stack:
            mbs = batch.reshape(accum, BATCH // accum, SAMPLES)
            g = jax.tree.map(lambda *x: sum(x) / accum,
                             *[grad_fn(p, jnp.asarray(mb)) for mb in mbs])
            for name, w in from_jax_params(jax.tree.map(np.asarray, g),
                                           tc).items():
                e = TOL["float32"]["grad"] * np.abs(w.numpy()).max()
                step = np.minimum(1.0, 2 * e / np.maximum(
                    np.abs(w.numpy()), 1e-30))
                sens[name] = np.maximum(sens.get(name, 0.0), step)
            p, s, _ = jsteps.train_step(p, s, jnp.asarray(batch))
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=TOL["float32"]["scalar"])
    want = from_jax_params(jax.tree.map(np.asarray, jp), tc)
    for name, q in model.named_parameters():
        d = np.abs(q.detach().numpy() - want[name].numpy())
        bound = 2 * LR * N * sens[name] + 1e-6
        assert (d <= bound).all(), (name, (d - bound).max())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("sets,match", [
    (["data.device_corpus=true"], "device_corpus"),
    (["train.parallel=cp"], "train.parallel"),
    (["train.parallel=dpcp"], "train.parallel"),
    ([*TRANSFORMER_SETS, "model.ar.kind=transformer", "model.ar.dropout=0.1",
      "model.ar.remat=true"], "remat with dropout"),
])
def test_multi_step_refuses_what_jax_or_a_capture_cannot_run(sets, match):
    cfg = _cfg("tpu_fast", sets)
    with pytest.raises(ValueError, match=match):
        make_multi_step(cfg, init_state(_cfg(), "cpu"), N)


def test_multi_step_refuses_tensor_parallelism_and_thread_ranks():
    cfg = _cfg("tpu_fast", ["train.mesh_axes=data,model",
                            "train.mesh_shape=1,2"])
    tp_mesh = thread_meshes(2, "cpu", model=2)[0]
    with pytest.raises(ValueError, match="tensor parallelism"):
        make_multi_step(cfg, init_state(_cfg(), "cpu"), N, tp_mesh)
    model = init_state(_cfg(), "cpu")
    model.tp_shards = {}
    with pytest.raises(ValueError, match="tensor parallelism"):
        make_multi_step(_cfg(), model, N)
    with pytest.raises(ValueError, match="thread ranks"):
        make_multi_step(_cfg(), init_state(_cfg(), "cpu"), N,
                        thread_meshes(1, "cpu")[0])


def test_multi_step_refuses_a_gloo_mesh():
    mesh = multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                                device="cpu", timeout=60)
    try:
        with pytest.raises(ValueError, match="gloo"):
            make_multi_step(_cfg(), init_state(_cfg(), "cpu"), N, mesh)
    finally:
        multihost.shutdown()


def test_multi_step_refuses_nan_debug_and_other_stacks():
    cfg = _cfg()
    with torch.autograd.set_detect_anomaly(True):
        with pytest.raises(ValueError, match="nan-debug"):
            make_multi_step(cfg, init_state(cfg, "cpu"), N)
    with pytest.raises(ValueError, match="n_steps"):
        make_multi_step(cfg, init_state(cfg, "cpu"), 0)
    multi, steps = make_multi_step(cfg, init_state(cfg, "cpu"), N)
    stack = _stacks(cfg, calls=1)[0]
    for bad in (stack[:2], stack.float(), stack[0]):
        with pytest.raises(ValueError, match="int16"):
            multi(bad)
    with torch.autograd.set_detect_anomaly(True):
        with pytest.raises(ValueError, match="nan-debug"):
            multi(stack)
    assert steps.optimizer.count == 0
    multi(stack)
    with pytest.raises(ValueError, match="captured"):
        multi(stack[:, :, :2000])
    with pytest.raises(ValueError, match="captured"):
        multi(stack[:, :2])
    assert steps.optimizer.count == N
    accum = _cfg("tpu_fast", ["train.accum_steps=3"])
    multi, _ = make_multi_step(accum, init_state(accum, "cpu"), N)
    with pytest.raises(ValueError, match="accum_steps"):
        multi(stack)


def _raise(*args):
    raise AssertionError("a host read")


def test_optimizer_step_reads_nothing_on_the_host(monkeypatch):
    t = tcfg.TrainConfig(learning_rate=1e-2, warmup_steps=3,
                         grad_clip_norm=0.5)
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in (("a", (3, 4)), ("b", (5,)))}
    grads = [{k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in p0.items()} for _ in range(4)]
    want = Optimizer({k: torch.from_numpy(v.copy()) for k, v in p0.items()},
                     t)
    for g in grads:
        want.step(g)
    got = Optimizer({k: torch.from_numpy(v.copy()) for k, v in p0.items()},
                    t)
    table = got.scalars(2, 2)
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "__bool__", _raise)
        m.setattr(torch.Tensor, "item", _raise)
        got.step(grads[0])
        got.step(grads[1])
        got.step(grads[2], table[0])
        got.step(grads[3], table[1])
    assert got.count == want.count == 4
    assert max(global_norm(g.values()) for g in grads) > t.grad_clip_norm
    for k in p0:
        assert torch.equal(got.params[k], want.params[k]), k
        assert torch.equal(got.mu[k], want.mu[k]), k
        assert torch.equal(got.nu[k], want.nu[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_multi_step_reads_nothing_on_the_host(monkeypatch, case):
    cfg = _cfg(*CASES[case])
    multi, _ = make_multi_step(cfg, init_state(cfg, "cpu"), N)
    stack = _stacks(cfg, calls=1)[0]
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "__bool__", _raise)
        m.setattr(torch.Tensor, "item", _raise)
        loss = multi(stack)
    assert torch.isfinite(loss)


def _resumed_against_straight(tmp_path, cfg, device="cpu"):
    stacks = _stacks(cfg, device=device)
    straight = init_state(cfg, device)
    multi, steps = make_multi_step(cfg, straight, N)
    for stack in stacks:
        multi(stack)
    first = init_state(cfg, device)
    multi, first_steps = make_multi_step(cfg, first, N)
    multi(stacks[0])
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(first_steps.optimizer.count, first.state_dict(),
              first_steps.optimizer.state_dict(), {})
    got = ckpt.restore_latest(map_location=device)
    resumed = init_state(cfg, device)
    multi, resumed_steps = make_multi_step(cfg, resumed, N)
    resumed.load_state_dict(got["model"])
    resumed_steps.optimizer.load_state_dict(got["optimizer"])
    multi(stacks[1])
    _assert_equal((resumed, resumed_steps.optimizer),
                  (straight, steps.optimizer))


def test_checkpoint_after_a_call_resumes_the_straight_run(tmp_path):
    # augmentation: the resumed call must draw the straight run's draws
    _resumed_against_straight(tmp_path, _cfg("tpu_fast",
                                             ["data.augment=true"]))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the steps are captured in a CUDA "
                    "graph")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_multi_equals_sequential_steps_on_the_card(case):
    _need_cuda()
    preset, sets = CASES[case]
    _multi_against_eager(_cfg(preset, sets), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["accum2", "transformer_clip_warmup"])
def test_multi_equals_sequential_steps_on_the_card_while_spans_record(case):
    _need_cuda()
    names = _multi_against_eager_recording(_cfg(*CASES[case]),
                                           device="cuda")
    assert "step.optimizer" in names


@pytest.mark.cuda
def test_checkpoint_after_a_replay_resumes_the_straight_run(tmp_path):
    _need_cuda()
    _resumed_against_straight(
        tmp_path, _cfg("tpu_fast", ["data.augment=true"]), device="cuda")


@pytest.mark.cuda
def test_another_stack_shape_raises_on_the_card():
    _need_cuda()
    cfg = _cfg()
    multi, _ = make_multi_step(cfg, init_state(cfg, "cuda"), N)
    stack = _stacks(cfg, calls=1, device="cuda")[0]
    multi(stack)
    assert multi.graph is not None
    with pytest.raises(ValueError, match="captured"):
        multi(stack[:, :2])
