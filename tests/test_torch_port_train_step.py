"""The training slice as a whole: two steps of the port's `make_step_fns`
against two of `cpc_tpu.train.train_step.make_step_fns`, on the same weights
(carried across by `from_jax_params`) and the same int16 batches (numpy).

The JAX side runs the fused heads + InfoNCE and the Pallas GRU in interpret
mode (`ar.use_pallas`, `loss.use_pallas`, `loss.fuse_heads`), at
`jax.default_matmul_precision('highest')`. Compared after each step: loss,
per-k accuracy, grad_norm, every gradient (JAX's gradients mapped through
`from_jax_params`, which is a pure re-layout) and the parameters after Adam.

Tolerances:
  * fp32: 1e-4 relative on loss and grad_norm, and on each gradient
    relative to its largest entry (summation order through a few layers);
    accuracy exact.
  * bf16 compute (`dtype=bfloat16`, `pallas_bf16`): both sides round
    activations and their gradients to bf16 at the same points, but their
    fp32 sums differ in order, so a value can land one bf16 ulp (2**-8
    relative) apart and carry on. Loss and grad_norm 1e-2 relative;
    gradients relative to their largest entry 3e-2, except the encoder's
    at 0.15: there JAX's own bf16 gradients lie up to 0.10 from its fp32
    ones (measured on these inputs; the port's lie 0.04 from its fp32
    ones), so the bound is that spread, not the port's. Accuracy: one row
    per k may flip, 1 / (Tp * B).
  * parameters after Adam: each step moves an entry by about lr * g / |g|,
    so a gradient error e moves it by at most about 2 lr min(1, 2 e / |g|)
    per step: near-zero gradients, whose sign the rounding can flip, get up
    to 2 lr per step, large ones almost nothing. e is the gradient bound
    above; plus 1e-6 for the fp32 update itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc_tpu import config as jcfg
from cpc_tpu.models.cpc import CPCModel as JaxCPCModel
from cpc_tpu.parallel.mesh import make_mesh
from cpc_tpu.train.train_step import make_step_fns as jax_make_step_fns
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.interop import from_jax_params
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.train.train_step import make_step_fns

BATCH, SAMPLES, LR = 4, 2000, 2e-4
TOL = {"float32": dict(scalar=1e-4, grad=1e-4, encoder_grad=1e-4, acc=0.0),
       "bfloat16": dict(scalar=1e-2, grad=3e-2, encoder_grad=0.15,
                        acc=None)}


def _cfg(dtype="float32", accum=1):
    bf16 = dtype == "bfloat16"
    return jcfg.CPCConfig(
        name="tiny",
        model=jcfg.ModelConfig(
            encoder=jcfg.EncoderConfig(channels=(16, 16), kernels=(10, 8),
                                       strides=(5, 4), d_enc=16),
            ar=jcfg.ArConfig(d_ar=8, use_pallas=True),
            loss=jcfg.LossConfig(prediction_steps=2, use_pallas=True,
                                 fuse_heads=True, pallas_bf16=bf16),
            dtype=dtype),
        data=jcfg.DataConfig(batch_size=BATCH, snippet_samples=SAMPLES),
        train=jcfg.TrainConfig(learning_rate=LR, accum_steps=accum))


def _params(cfg, seed=0):
    """JAX params drawn from a numpy seed (biases nonzero too)."""
    shapes = jax.eval_shape(JaxCPCModel(cfg.model).init, jax.random.key(0),
                            jnp.zeros((1, SAMPLES)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key in ("bias", "bi", "bh"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                ).astype(np.float32)
    return {"params": jax.tree_util.tree_map_with_path(draw, shapes)}


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [np.clip(rng.standard_normal((BATCH, SAMPLES)) * 6000, -32768,
                    32767).astype(np.int16) for _ in range(n)]


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _check_step(tc, jm, tm, jgrads, model, params, tol, K, sens, n_step):
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=tol["scalar"])
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=tol["scalar"])
    Tp = SAMPLES // 20 - K
    acc_tol = tol["acc"] if tol["acc"] is not None else 1.0 / (Tp * BATCH)
    np.testing.assert_allclose(tm["acc"].numpy(), np.asarray(jm["acc"]),
                               rtol=0, atol=acc_tol + 1e-7)
    want_g = from_jax_params(jax.tree.map(np.asarray, jgrads), tc)
    accum = tc.train.accum_steps
    for name, p in model.named_parameters():
        g = p.grad.numpy() / accum
        w = want_g[name].numpy()
        gtol = tol["encoder_grad" if name.startswith("encoder.") else "grad"]
        assert _rel(g, w) <= gtol, (name, _rel(g, w))
        e = gtol * np.abs(w).max()
        step_sens = np.minimum(1.0, 2 * e / np.maximum(np.abs(w), 1e-30))
        sens[name] = np.maximum(sens.get(name, 0.0), step_sens)
    want_p = from_jax_params(jax.tree.map(np.asarray, params), tc)
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - want_p[name].numpy())
        bound = 2 * LR * n_step * sens[name] + 1e-6
        assert (d <= bound).all(), (name, (d - bound).max())


def _jax_grads(grad_fn, params, batch, accum):
    """Mean over microbatches of the JAX loss's gradient."""
    mbs = batch.reshape(accum, BATCH // accum, SAMPLES)
    gs = [grad_fn(params, jnp.asarray(mb)) for mb in mbs]
    return jax.tree.map(lambda *x: sum(x) / accum, *gs)


@pytest.mark.parametrize("dtype,accum", [("float32", 1), ("bfloat16", 1),
                                         ("float32", 2)])
def test_two_train_steps_match_jax(dtype, accum):
    cfg = _cfg(dtype, accum)
    K = cfg.model.loss.prediction_steps
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    jsteps = jax_make_step_fns(cfg, JaxCPCModel(cfg.model), mesh)
    params = _params(cfg)
    opt_state = jsteps.optimizer.init(params)

    tc = tcfg.from_dict(jcfg.to_dict(cfg))
    model = CPCModel(tc.model)
    model.load_state_dict(from_jax_params(params, tc))
    steps = make_step_fns(tc, model)
    tol, sens = TOL[dtype], {}
    grad_fn = jax.jit(jax.grad(lambda p, b: jsteps.loss_fn(p, b)[0]))
    with jax.default_matmul_precision("highest"):
        for n_step, batch in enumerate(_batches(2), 1):
            jgrads = _jax_grads(grad_fn, params, batch, accum)
            params, opt_state, jm = jsteps.train_step(params, opt_state,
                                                      jnp.asarray(batch))
            tm = steps.train_step(torch.from_numpy(batch))
            _check_step(tc, jm, tm, jgrads, model, params, tol, K, sens,
                        n_step)


def test_eval_step_matches_loss_fn_and_leaves_params():
    tc = tcfg.from_dict(jcfg.to_dict(_cfg()))
    model = CPCModel(tc.model, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    steps = make_step_fns(tc, model)
    batch = torch.from_numpy(_batches(1)[0])
    m = steps.eval_step(batch)
    loss, _ = steps.loss_fn(model, batch)
    assert m["loss"].item() == loss.item() and m["acc"].shape == (2,)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


@pytest.mark.parametrize("change,match", [
    (dict(train=dict(parallel="cp")), "§A13"),
    (dict(train=dict(mesh_shape=(2,))), "§A13"),
    (dict(data=dict(device_corpus=True)), "§A8"),
    (dict(data=dict(augment=True)), "§A9"),
])
def test_unported_training_modes_raise(change, match):
    cfg = tcfg.from_dict(jcfg.to_dict(_cfg()))
    for section, fields in change.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **fields)})
    with pytest.raises(NotImplementedError, match=match):
        make_step_fns(cfg, CPCModel(cfg.model))


def test_unfused_pallas_loss_raises_and_plain_loss_runs():
    # the unfused kernel route no longer raises: it runs the same-step
    # kernels' module (tests/test_torch_port_loss_paths.py holds it against
    # the JAX package), and equals the plain and the fused loss
    cfg = tcfg.from_dict(jcfg.to_dict(_cfg()))
    loss = dataclasses.replace(cfg.model.loss, fuse_heads=False)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             loss=loss))
    model = CPCModel(cfg.model, generator=torch.Generator().manual_seed(0))
    batch = torch.from_numpy(_batches(1)[0])
    unfused = make_step_fns(cfg, model).loss_fn(model, batch)[0].item()
    plain = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, loss=dataclasses.replace(loss, use_pallas=False)))
    fused = make_step_fns(tcfg.from_dict(jcfg.to_dict(_cfg())), model)
    # same_step on materialized preds equals the fused loss
    np.testing.assert_allclose(
        make_step_fns(plain, model).loss_fn(model, batch)[0].item(),
        fused.loss_fn(model, batch)[0].item(), rtol=1e-5)
    np.testing.assert_allclose(unfused, fused.loss_fn(model, batch)[0].item(),
                               rtol=1e-5)
