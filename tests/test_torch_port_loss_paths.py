"""The two loss paths on materialized predictions as a whole: two steps of
the port's `make_step_fns` against two of
`cpc_tpu.train.train_step.make_step_fns`, with `loss.fuse_heads=False` (the
same-step kernel) and with `loss.negatives="all_steps"` (the all-steps
kernel), `loss.use_pallas=True` on both sides. The weights cross through
`from_jax_params` (the parameters are those of the fused path: the mapping
needs nothing new) and the int16 batches are numpy's. Then three steps of
each path through `cpc_tpu_torch.train.cli.main` on the CPU.

The JAX side runs its Pallas kernels (GRU, K-tiled InfoNCE, all-steps
InfoNCE) in interpret mode at `jax.default_matmul_precision('highest')`.
The helpers and the bounds are those of `test_torch_port_train_step.py`,
whose docstring derives them: fp32 1e-4 on loss, grad_norm and each gradient
relative to its largest entry, accuracy exact; bf16 1e-2 on the scalars,
3e-2 on gradients (0.15 for the encoder's, JAX's own bf16 spread), one row
per k on accuracy; parameters after Adam within 2 lr per step where the
gradient's sign is in doubt.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from cpc_tpu import config as jcfg
from cpc_tpu.models.cpc import CPCModel as JaxCPCModel
from cpc_tpu.parallel.mesh import make_mesh
from cpc_tpu.train.train_step import make_step_fns as jax_make_step_fns
from cpc_tpu.train.train_step import resolve_fuse_heads as jax_resolve
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.interop import from_jax_params
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.ops.infonce_allsteps_cuda import allsteps_nll_forward
from cpc_tpu_torch.ops.infonce_cuda import same_step_nll_forward
from cpc_tpu_torch.train import cli
from cpc_tpu_torch.train.train_step import make_step_fns, resolve_fuse_heads
from test_torch_port_train_step import (TOL, _batches, _check_step, _cfg,
                                        _jax_grads, _params)
from test_torch_port_trainer import TINY

PATHS = {"fuse_heads=false": dict(fuse_heads=False),
         "all_steps": dict(negatives="all_steps")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny tensors: one intra-op thread, so that parallel test workers do
    # not oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path_cfg(path, dtype):
    cfg = _cfg(dtype)
    loss = dataclasses.replace(cfg.model.loss, **PATHS[path])
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, loss=loss))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", list(PATHS))
def test_two_train_steps_match_jax(path, dtype):
    cfg = _path_cfg(path, dtype)
    K = cfg.model.loss.prediction_steps
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    assert not jax_resolve(cfg, mesh)
    jsteps = jax_make_step_fns(cfg, JaxCPCModel(cfg.model), mesh)
    params = _params(cfg)
    opt_state = jsteps.optimizer.init(params)

    tc = tcfg.from_dict(jcfg.to_dict(cfg))
    assert not resolve_fuse_heads(tc)
    model = CPCModel(tc.model)
    model.load_state_dict(from_jax_params(params, tc))
    steps = make_step_fns(tc, model)
    tol, sens = TOL[dtype], {}
    grad_fn = jax.jit(jax.grad(lambda p, b: jsteps.loss_fn(p, b)[0]))
    with jax.default_matmul_precision("highest"):
        for n_step, batch in enumerate(_batches(2), 1):
            jgrads = _jax_grads(grad_fn, params, batch, 1)
            params, opt_state, jm = jsteps.train_step(params, opt_state,
                                                      jnp.asarray(batch))
            tm = steps.train_step(torch.from_numpy(batch))
            _check_step(tc, jm, tm, jgrads, model, params, tol, K, sens,
                        n_step)


@pytest.mark.parametrize("path,wrapper", [
    ("fuse_heads=false", same_step_nll_forward),
    ("all_steps", allsteps_nll_forward)])
def test_three_steps_through_the_cli_on_cpu(path, wrapper, tmp_path):
    before = wrapper.launches
    field = "fuse_heads=false" if path == "fuse_heads=false" \
        else "negatives=all_steps"
    assert cli.main([*TINY, "--workdir", str(tmp_path), "--steps", "3",
                     "--set", f"model.loss.{field}"]) == 0
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3]
    for r in train:
        assert len(r["acc"]) == 3
        assert all(v == v and abs(v) < 1e6 for v in (r["loss"],
                                                     r["grad_norm"]))
    saved = json.loads((tmp_path / "config.json").read_text())["model"]["loss"]
    assert saved["use_pallas"] and saved["pallas_bf16"]
    assert (saved["fuse_heads"], saved["negatives"]) == (
        (False, "same_step") if path == "fuse_heads=false"
        else (True, "all_steps"))
    assert wrapper.launches == before  # the CPU runs the plain versions
