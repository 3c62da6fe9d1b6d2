"""The port's optimizer (`train/train_step.py::make_optimizer`) against the
JAX package's, which is optax: the same gradients fed step by step to both,
the parameters compared after every step.

Pinned here: eps outside the square root, the bias correction, the schedule
count starting at 0 (with warmup the first update uses lr 0), the constant
and cosine schedules with warmup (decay_steps = max(num_steps, warmup+1)),
clip_by_global_norm as (g / norm) * max above the threshold, and AdamW's
decoupled decay. fp32 throughout, parameters of magnitude about 1:
1e-6 relative and 3e-7 absolute (2.5 ulps at 1..2), as the two sides
differ only in where XLA fuses or rounds an fp32 operation, which can move
a parameter by an ulp at a step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpc_tpu import config as jcfg
from cpc_tpu.train.train_step import make_optimizer as jax_make_optimizer
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.train.train_step import (Optimizer, global_norm,
                                            make_schedule)

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}


def _cfg(**train):
    return jcfg.CPCConfig(train=jcfg.TrainConfig(**{
        "learning_rate": 1e-2, "num_steps": 6, **train}))


def _run_both(cfg, steps=6, grad_scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    opt = jax_make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = Optimizer(tp, tcfg.from_dict(jcfg.to_dict(cfg)).train)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.step({k: torch.from_numpy(v) for k, v in g.items()})
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=3e-7, err_msg=k)
    return p0, tp


@pytest.mark.parametrize("train", [
    {},                                                  # Adam, constant
    {"weight_decay": 0.1},                               # AdamW
    {"warmup_steps": 3},                                 # linear warmup
    {"lr_schedule": "cosine"},                           # cosine, no warmup
    {"lr_schedule": "cosine", "warmup_steps": 2},        # warmup + cosine
    {"lr_schedule": "cosine", "warmup_steps": 8},        # warmup > steps
    {"grad_clip_norm": 0.5},                             # clipping fires
    {"grad_clip_norm": 1e3},                             # clipping idle
    {"grad_clip_norm": 0.5, "weight_decay": 0.05, "lr_schedule": "cosine",
     "warmup_steps": 2, "beta1": 0.8, "beta2": 0.99},
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()) or "adam")
def test_optimizer_matches_optax(train):
    _run_both(_cfg(**train))


def test_first_warmup_update_uses_lr_zero():
    p0, tp = _run_both(_cfg(warmup_steps=4), steps=1)
    for k in SHAPES:
        np.testing.assert_array_equal(tp[k].numpy(), p0[k])


def test_eps_is_outside_the_square_root():
    # a tiny gradient: m_hat / (sqrt(v_hat) + eps) = g / (|g| + eps), far
    # from g / sqrt(g^2 + eps) when |g| ~ eps
    _run_both(_cfg(), steps=3, grad_scale=1e-8)


@pytest.mark.parametrize("kind,warmup,num", [("constant", 0, 10),
                                             ("constant", 4, 10),
                                             ("cosine", 0, 10),
                                             ("cosine", 3, 10),
                                             ("cosine", 5, 5)])
def test_schedule_matches_optax(kind, warmup, num):
    t = jcfg.TrainConfig(learning_rate=3e-3, lr_schedule=kind,
                         warmup_steps=warmup, num_steps=num)
    ours = make_schedule(tcfg.from_dict(jcfg.to_dict(
        dataclasses.replace(_cfg(), train=t))).train)
    lr = t.learning_rate
    if kind == "cosine":
        theirs = optax.warmup_cosine_decay_schedule(
            0.0 if warmup else lr, lr, warmup, max(num, warmup + 1))
    elif warmup:
        theirs = optax.linear_schedule(0.0, lr, warmup)
    else:
        def theirs(n):
            return lr
    for n in range(num + 3):
        np.testing.assert_allclose(ours(n), float(theirs(n)), rtol=1e-6,
                                   atol=1e-12)


def test_global_norm_matches_optax():
    g = {k: np.random.default_rng(1).standard_normal(s).astype(np.float32)
         for k, s in SHAPES.items()}
    np.testing.assert_allclose(
        global_norm(torch.from_numpy(v) for v in g.values()).item(),
        float(optax.global_norm(jax.tree.map(jnp.asarray, g))), rtol=1e-6)


def test_state_dict_round_trip_continues_identically():
    t = tcfg.TrainConfig(learning_rate=1e-2, warmup_steps=2,
                         lr_schedule="cosine", num_steps=6)
    rng = np.random.default_rng(2)
    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for k, s in SHAPES.items()}
    grads = [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in SHAPES.items()} for _ in range(4)]
    a = Optimizer({k: v.clone() for k, v in p.items()}, t)
    for g in grads:
        a.step(g)
    b = Optimizer({k: v.clone() for k, v in p.items()}, t)
    for g in grads[:2]:
        b.step(g)
    c = Optimizer(b.params, t)
    c.load_state_dict(b.state_dict())
    for g in grads[2:]:
        c.step(g)
    for k in SHAPES:
        torch.testing.assert_close(c.params[k], a.params[k], rtol=0, atol=0)
