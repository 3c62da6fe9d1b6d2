"""The port's context parallelism against the JAX package's shard_map runs
on the conftest's virtual CPU devices, with the ranks played by threads
(`mesh.thread_meshes`, `ring_util.run_thread_ranks`):

  * `ring_causal_mha` at R = 2, 4 and `zigzag_causal_mha` at R = 2-5 (odd
    R included), forward and the three gradients, at JAX's 2e-5 and 3e-5
    (tests/test_ring_attention.py); zigzag's odd-T_loc raise;
  * the transformer's ring route (`cp_transformer_apply`, ring and
    zigzag, the positional table at each shard's offset): output 2e-5,
    parameter gradients 5e-5;
  * the halo encoder (`ConvEncoder._cp_forward`) under each norm: output
    1e-5, gradients 2e-4 against JAX's CP encoder;
  * `cp_cpc_loss_and_metrics` from latents, `cp_cpc_loss_from_audio` with
    ring and zigzag on a ctx ring of 4 and on the (2, 2) DP x CP mesh: the
    loss at 1e-5 / 1e-6, the accuracy EXACTLY against JAX's CP run, the
    parameter gradients at 5e-5;
  * the CP and DP x CP training steps (`make_cp_step_fns`, with and
    without augmentation) against the port's single-process step on the
    whole batch: loss, accuracy, grad_norm and the gradient of the update;
  * the checks, with the JAX package's messages; the trainer and the
    training CLI under train.parallel='cp' at a world of one, resumed bit
    for bit.

JAX at `jax.default_matmul_precision('highest')`, fp32; one torch thread.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from cpc_tpu import config as jcfg
from cpc_tpu.models.cpc import CPCModel as JModel
from cpc_tpu.models.encoder import ConvEncoder as JEncoder
from cpc_tpu.models.transformer import CausalTransformer as JTransformer
from cpc_tpu.ops.attention_ring import ring_causal_mha as j_ring
from cpc_tpu.ops.attention_zigzag import zigzag_causal_mha as j_zigzag
from cpc_tpu.parallel import cp as jcp
from cpc_tpu_torch import config as tcfg
from cpc_tpu_torch.interop import (encoder_state_dict, from_jax_params,
                                   transformer_state_dict)
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.models.encoder import ConvEncoder
from cpc_tpu_torch.models.transformer import CausalTransformer
from cpc_tpu_torch.ops.attention_ring import ring_causal_mha
from cpc_tpu_torch.ops.attention_zigzag import zigzag_causal_mha
from cpc_tpu_torch.ops.ring_util import run_thread_ranks
from cpc_tpu_torch.parallel import cp
from cpc_tpu_torch.parallel.mesh import groups_of, thread_meshes
from cpc_tpu_torch.train import cli
from cpc_tpu_torch.train.train_step import make_step_fns

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
ATTN_GRAD_TOL = dict(rtol=3e-5, atol=3e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_GRAD_TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def ranks(world, fn, ctx=None):
    """fn(mesh) on `world` thread ranks, ctx of them (default all) to a
    data row; returns their results in rank order."""
    meshes = thread_meshes(world, "cpu", ctx=ctx or world, timeout=60)
    return run_thread_ranks(groups_of(meshes),
                            [functools.partial(fn, m) for m in meshes],
                            timeout=120)


def jax_mesh(shape, axes=("ctx",)):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


def local(x: np.ndarray, mesh, dp=False) -> torch.Tensor:
    """This rank's (rows, time) shard of a global array, time on axis 1."""
    return cp.shard(torch.from_numpy(np.array(x)), mesh, "ctx",
                    "data" if dp else None)


def whole(parts, data, ctx):
    """Reassembles rank-ordered (B_loc, T_loc, ...) shards."""
    return np.concatenate([np.concatenate(parts[r * ctx:(r + 1) * ctx], 1)
                           for r in range(data)], 0)


def summed(grads):
    """The ranks' parameter gradients summed, name by name."""
    return {k: sum(g[k] for g in grads) for k in grads[0]}


def held_grads(got: dict, want: dict, tol) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k, **tol)


# ---------------------------------------------------------- ring attention
def _qkv(T, B=2, H=2, Dh=8, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, T, H, Dh)).astype(np.float32)
            for _ in range(4)]  # q, k, v and the output's cotangent w


def _jax_attention(fn, q, k, v, w, shape, axes=("ctx",)):
    mesh = jax_mesh(shape, axes)
    spec = P("data" if len(axes) == 2 else None, "ctx", None, None)
    run = jax.jit(jax.shard_map(functools.partial(fn, axis_name="ctx"),
                                mesh=mesh, in_specs=(spec,) * 3,
                                out_specs=spec))
    out = run(q, k, v)
    grads = jax.grad(lambda a, b, c: jnp.sum(run(a, b, c) * w),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_attention(fn, q, k, v, w, world, ctx):
    dp = world > ctx

    def rank(mesh):
        t = [local(a, mesh, dp).clone().requires_grad_() for a in (q, k, v)]
        out = fn(*t, mesh=mesh)
        (out * local(w, mesh, dp)).sum().backward()
        return [out.detach().numpy()] + [a.grad.numpy() for a in t]

    res = ranks(world, rank, ctx)
    return [whole([r[i] for r in res], world // ctx, ctx) for i in range(4)]


def _held_attention(port_fn, jax_fn, T, R, data=1, seed=0):
    q, k, v, w = _qkv(T, B=2 * data, seed=seed)
    shape, axes = ((data, R), ("data", "ctx")) if data > 1 else ((R,),
                                                                 ("ctx",))
    want_o, want_g = _jax_attention(jax_fn, q, k, v, w, shape, axes)
    out, *grads = _port_attention(port_fn, q, k, v, w, R * data, R)
    np.testing.assert_allclose(out, want_o, **ATTN_TOL)
    for got, want, name in zip(grads, want_g, "qkv"):
        np.testing.assert_allclose(got, want, err_msg=f"d{name}",
                                   **ATTN_GRAD_TOL)


@pytest.mark.parametrize("R", [2, 4])
def test_ring_attention_matches_jax(R):
    _held_attention(ring_causal_mha, j_ring, T=R * 8, R=R, seed=R)


@pytest.mark.parametrize("R", [2, 3, 4, 5])
def test_zigzag_attention_matches_jax(R):
    # odd R included (tests/test_ring_attention.py::test_zigzag_odd_ring_sizes)
    _held_attention(zigzag_causal_mha, j_zigzag, T=R * 2 * 4, R=R,
                    seed=40 + R)


def test_zigzag_attention_on_a_2d_mesh_matches_jax():
    _held_attention(zigzag_causal_mha, j_zigzag, T=2 * 8, R=2, data=2,
                    seed=33)


def test_zigzag_needs_an_even_local_length():
    q = torch.zeros(1, 3, 2, 4)
    with pytest.raises(ValueError, match="even per-device T"):
        zigzag_causal_mha(q, q, q, mesh=thread_meshes(1, "cpu")[0])


# ------------------------------------------------------ the transformer gar
def _ar(T, impl):
    kw = dict(kind="transformer", d_ar=16, num_layers=2, num_heads=2,
              max_len=T, attn_impl=impl)
    return jcfg.ArConfig(**kw), tcfg.ArConfig(**kw)


@pytest.mark.parametrize("impl", ["ring", "zigzag"])
def test_cp_transformer_matches_jax(impl):
    R, T, D = 4, 4 * 8, 12
    jar, tar = _ar(T, impl)
    z = np.random.default_rng(17).standard_normal((2, T, D)
                                                  ).astype(np.float32)
    w = np.random.default_rng(18).standard_normal((2, T, 16)
                                                  ).astype(np.float32)
    jref = JTransformer(dataclasses.replace(jar, attn_impl="xla"))
    params = jref.init(jax.random.PRNGKey(5), z)
    mesh = jax_mesh((R,))
    want = jcp.cp_transformer_apply(jar, params, z, mesh=mesh)
    want_g = jax.grad(lambda p: jnp.sum(jcp.cp_transformer_apply(
        jar, p, z, mesh=mesh) * w))(params)
    want_g = transformer_state_dict(want_g["params"], tar, D)
    sd = transformer_state_dict(params["params"], tar, D)

    def rank(mesh):
        gar = CausalTransformer(D, tar)
        gar.load_state_dict(sd)
        out = cp.cp_transformer_apply(gar, local(z, mesh), mesh=mesh)
        (out * local(w, mesh)).sum().backward()
        return out.detach().numpy(), {k: p.grad.numpy()
                                      for k, p in gar.named_parameters()}

    res = ranks(R, rank)
    np.testing.assert_allclose(whole([r[0] for r in res], 1, R),
                               np.asarray(want), **ATTN_TOL)
    np.testing.assert_allclose(np.asarray(want), np.asarray(
        jref.apply(params, z)), **ATTN_TOL)
    held_grads(summed([r[1] for r in res]), want_g, PARAM_GRAD_TOL)


def test_ring_transformer_outside_a_mesh_raises():
    _, tar = _ar(16, "ring")
    gar = CausalTransformer(4, tar)
    with pytest.raises(ValueError, match="axis_env"):
        gar(torch.zeros(1, 8, 4))
    mesh = thread_meshes(1, "cpu")[0]
    with pytest.raises(ValueError, match="max_len"):
        cp.cp_transformer_apply(gar, torch.zeros(1, 32, 4), mesh=mesh)


# -------------------------------------------------------- the halo encoder
@pytest.mark.parametrize("norm", ["none", "layer", "group", "batch"])
def test_halo_encoder_matches_jax(norm):
    R = 4
    kw = dict(channels=(8, 12, 16), kernels=(10, 8, 4), strides=(5, 4, 2),
              d_enc=16, norm=norm)
    jenc, tenc = jcfg.EncoderConfig(**kw), tcfg.EncoderConfig(**kw)
    x = np.random.default_rng(0).standard_normal((2, R * 40 * 4)
                                                 ).astype(np.float32)
    ref, cp_enc = JEncoder(jenc), JEncoder(jenc, cp_axis="ctx")
    params = ref.init(jax.random.PRNGKey(0), x)
    run = jax.jit(jax.shard_map(
        lambda p, xx: cp_enc.apply(p, xx), mesh=jax_mesh((R,)),
        in_specs=(P(), P(None, "ctx")), out_specs=P(None, "ctx", None)))
    want = np.asarray(run(params, x))
    want_g = jax.grad(lambda p: jnp.sum(jnp.tanh(run(p, x))))(params)
    want_g = encoder_state_dict(want_g["params"], tenc)
    sd = encoder_state_dict(params["params"], tenc)

    def rank(mesh):
        enc = ConvEncoder(tenc)
        enc.load_state_dict(sd)
        z = enc._cp_forward(local(x, mesh), mesh.ring("ctx"))
        torch.tanh(z).sum().backward()
        return z.detach().numpy(), {k: p.grad.numpy()
                                    for k, p in enc.named_parameters()}

    res = ranks(R, rank)
    np.testing.assert_allclose(whole([r[0] for r in res], 1, R), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(want, np.asarray(ref.apply(params, x)),
                               rtol=1e-5, atol=1e-5)
    held_grads(summed([r[1] for r in res]), want_g,
               dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("kw,match", [
    (dict(padding="VALID"), "padding='SAME'"),
    (dict(use_pallas=True), "use_pallas=False")])
def test_halo_encoder_takes_same_padding_and_the_plain_route(kw, match):
    enc = ConvEncoder(tcfg.EncoderConfig(channels=(4,), kernels=(4,),
                                         strides=(2,), d_enc=4, **kw))
    mesh = thread_meshes(1, "cpu")[0]
    with pytest.raises(ValueError, match=match):
        enc._cp_forward(torch.zeros(1, 8), mesh.ring("ctx"))
    with pytest.raises(ValueError, match="must divide by prod"):
        ConvEncoder(tcfg.EncoderConfig(channels=(4,), kernels=(4,),
                                       strides=(2,), d_enc=4)
                    )._cp_forward(torch.zeros(1, 7), mesh.ring("ctx"))


# ------------------------------------------------------------- the CP loss
def _model_cfgs(T, impl="ring", **enc):
    kw = dict(
        encoder=dict(channels=(8, 16), kernels=(4, 4), strides=(2, 2),
                     d_enc=16, **enc),
        ar=dict(kind="transformer", d_ar=16, num_layers=1, num_heads=2,
                max_len=T, attn_impl=impl),
        loss=dict(prediction_steps=3, negatives="all_steps"))
    j = jcfg.ModelConfig(encoder=jcfg.EncoderConfig(**kw["encoder"]),
                         ar=jcfg.ArConfig(**kw["ar"]),
                         loss=jcfg.LossConfig(**kw["loss"]))
    t = tcfg.ModelConfig(encoder=tcfg.EncoderConfig(**kw["encoder"]),
                         ar=tcfg.ArConfig(**kw["ar"]),
                         loss=tcfg.LossConfig(**kw["loss"]))
    return j, t


def _jax_params(jmc, x, seed):
    ref = JModel(dataclasses.replace(jmc, ar=dataclasses.replace(
        jmc.ar, attn_impl="xla")))
    return ref, ref.init(jax.random.PRNGKey(seed), x)


def _port_state(params, tmc):
    return from_jax_params(params, tcfg.CPCConfig(model=tmc))


def _port_cp_loss(tmc, sd, inputs, world, ctx, fn):
    """fn(model, shard, mesh) -> (loss, metrics) on thread ranks; returns
    the loss, acc (every rank's alike) and the summed gradients."""
    dp = world > ctx

    def rank(mesh):
        model = CPCModel(cp.cp_model_config(tmc))
        model.load_state_dict(sd)
        loss, m = fn(model, local(inputs, mesh, dp), mesh)
        loss.backward()
        return loss.item(), m["acc"].numpy(), {
            k: p.grad.numpy() for k, p in model.named_parameters()
            if p.grad is not None}

    res = ranks(world, rank, ctx)
    for r in res[1:]:
        assert r[0] == res[0][0] and np.array_equal(r[1], res[0][1])
    return res[0][0], res[0][1], summed([r[2] for r in res])


def test_cp_loss_from_latents_matches_jax():
    R, T = 4, 4 * 8
    jmc, tmc = _model_cfgs(T)
    x = np.random.default_rng(5).standard_normal((2, T * 4)
                                                 ).astype(np.float32)
    ref, params = _jax_params(jmc, x, 0)
    z = ref.apply(params, x, method=JModel.encode)
    mesh = jax_mesh((R,))

    def jloss(p):
        return jcp.cp_cpc_loss_and_metrics(jmc, p, z, mesh=mesh)
    want, want_m = jloss(params)
    want_g = _port_state(jax.grad(lambda p: jloss(p)[0])(params), tmc)
    want_g = {k: v for k, v in want_g.items() if not k.startswith("encoder")}
    loss, acc, grads = _port_cp_loss(
        tmc, _port_state(params, tmc), np.asarray(z), R, R,
        lambda model, zz, mesh: cp.cp_cpc_loss_and_metrics(model, zz,
                                                           mesh=mesh))
    np.testing.assert_allclose(loss, float(want), **LOSS_TOL)
    np.testing.assert_array_equal(acc, np.asarray(want_m["acc"]))
    held_grads({k: v for k, v in grads.items()
                if not k.startswith("encoder")}, want_g, PARAM_GRAD_TOL)


@pytest.mark.parametrize("impl,shape", [
    ("ring", (4,)), ("zigzag", (4,)), ("ring", (2, 2)), ("zigzag", (2, 2))],
    ids=["ring", "zigzag", "dpcp-ring", "dpcp-zigzag"])
def test_cp_loss_from_audio_matches_jax(impl, shape):
    data, R = shape if len(shape) == 2 else (1, shape[0])
    T = R * 8
    jmc, tmc = _model_cfgs(T, impl)
    x = np.random.default_rng(13).standard_normal((2 * data, T * 4)
                                                  ).astype(np.float32)
    ref, params = _jax_params(jmc, x, 4)
    dp = "data" if data > 1 else None
    mesh = jax_mesh(shape, ("data", "ctx") if dp else ("ctx",))

    def jloss(p):
        return jcp.cp_cpc_loss_from_audio(jmc, p, x, mesh=mesh, axis="ctx",
                                          dp_axis=dp)
    want, want_m = jloss(params)
    want_g = _port_state(jax.grad(lambda p: jloss(p)[0])(params), tmc)
    loss, acc, grads = _port_cp_loss(
        tmc, _port_state(params, tmc), x, data * R, R,
        lambda model, xs, mesh: cp.cp_cpc_loss_from_audio(
            model, xs, mesh=mesh, dp_axis=dp))
    np.testing.assert_allclose(loss, float(want), **LOSS_TOL)
    np.testing.assert_array_equal(acc, np.asarray(want_m["acc"]))
    held_grads(grads, want_g, PARAM_GRAD_TOL)


# -------------------------------------------------------- the training step
def _cfg(parallel="cp", mesh_shape=(-1,), mesh_axes=("data",), **data):
    T = 16
    return tcfg.CPCConfig(
        name="tiny-cp",
        model=tcfg.ModelConfig(
            encoder=tcfg.EncoderConfig(channels=(8, 8), kernels=(10, 8),
                                       strides=(5, 4), d_enc=8),
            ar=tcfg.ArConfig(kind="transformer", d_ar=8, num_layers=1,
                             num_heads=2, max_len=T),
            loss=tcfg.LossConfig(prediction_steps=2, negatives="all_steps")),
        data=tcfg.DataConfig(batch_size=4, snippet_samples=T * 20, **data),
        train=tcfg.TrainConfig(parallel=parallel, mesh_shape=mesh_shape,
                               mesh_axes=mesh_axes, learning_rate=1e-3,
                               grad_clip_norm=1.0))


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.clip(rng.standard_normal(
        (cfg.data.batch_size, cfg.data.snippet_samples)) * 6000, -32768,
        32767).astype(np.int16))


def _step(cfg, model, mesh, batch):
    """One train step; returns its metrics and the gradient it applied."""
    steps = make_step_fns(cfg, model, mesh)
    seen = {}
    update = steps.optimizer.step

    def spy(grads):
        seen.update({k: g.detach().clone() for k, g in grads.items()})
        update(grads)
    steps.optimizer.step = spy
    m = steps.train_step(batch)
    return {k: v.numpy() for k, v in m.items()}, seen


@pytest.mark.parametrize("parallel,world,ctx,augment", [
    ("cp", 1, 1, False), ("cp", 2, 2, False), ("cp", 4, 4, False),
    ("dpcp", 4, 2, False), ("dpcp", 4, 2, True)],
    ids=["cp1", "cp2", "cp4", "dpcp", "dpcp-augment"])
def test_cp_step_equals_the_single_device_step(parallel, world, ctx,
                                               augment):
    shape, axes = ((-1,), ("data",)) if parallel == "cp" else \
        ((world // ctx, ctx), ("data", "ctx"))
    cfg = _cfg(parallel, shape, axes, augment=augment)
    single = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, parallel="dp", mesh_shape=(-1,), mesh_axes=("data",)))
    batch = _batch(cfg)
    seed = torch.Generator().manual_seed(0)
    want_m, want_g = _step(single, CPCModel(single.model, generator=seed),
                           None, batch)

    def rank(mesh):
        model = CPCModel(cp.cp_model_config(cfg.model),
                         generator=torch.Generator().manual_seed(0))
        return _step(cfg, model, mesh, batch)

    for m, g in ranks(world, rank, ctx):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[k], want_m[k], err_msg=k,
                                       **LOSS_TOL)
        np.testing.assert_allclose(m["acc"], want_m["acc"], atol=1e-6)
        held_grads({k: v.numpy() for k, v in g.items()}, want_g,
                   PARAM_GRAD_TOL)


def test_cp_step_without_a_mesh_is_a_ring_of_one():
    cfg = _cfg()
    model = CPCModel(cp.cp_model_config(cfg.model),
                     generator=torch.Generator().manual_seed(0))
    steps = make_step_fns(cfg, model)
    m = steps.train_step(_batch(cfg))
    e = steps.eval_step(_batch(cfg))
    assert all(bool(torch.isfinite(v).all()) for v in (*m.values(),
                                                       *e.values()))


# ------------------------------------------------------------- the checks
def _changed(cfg, section, **fields):
    return dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **fields)})


def _loss_changed(**fields):
    cfg = _cfg()
    return _changed(cfg, "model", loss=dataclasses.replace(cfg.model.loss,
                                                           **fields))


CHECKS = [
    (_changed(_cfg(), "model", ar=dataclasses.replace(
        _cfg().model.ar, dropout=0.1)), "no dropout path"),
    (_changed(_cfg(), "train", accum_steps=2), "gradient accumulation"),
    (_loss_changed(use_pallas=True), r"\['loss.use_pallas'\]"),
    (_loss_changed(cross_replica=False, ring=True),
     r"\['loss.cross_replica', 'loss.ring'\]"),
    (_loss_changed(negatives="same_step"), "all_steps pool by construction"),
    (_changed(_cfg(), "model", ar=tcfg.ArConfig(kind="gru", d_ar=8)),
     "inherently sequential"),
    (_changed(_cfg(), "data", snippet_samples=321),
     "not divisible by the 2-way ctx"),
    (_changed(_cfg(), "model", encoder=tcfg.EncoderConfig(kind="scalogram")),
     "halo exchange"),
    (_cfg("dpcp", (2,), ("ctx",)), "needs a 2-D mesh"),
    (_cfg("cp", (2, 1), ("data", "model")), "does not combine"),
    (_cfg("cp", (2, 1), ("data", "ctx")), "shards time alone"),
]


@pytest.mark.parametrize("cfg,match", CHECKS,
                         ids=[str(i) for i in range(len(CHECKS))])
def test_cp_checks_raise_with_the_jax_messages(cfg, match):
    model = CPCModel(cp.cp_model_config(_cfg().model))
    with pytest.raises((ValueError, NotImplementedError), match=match):
        make_step_fns(cfg, model, thread_meshes(2, "cpu")[0])


def test_cp_axis_checks():
    _, tmc = _model_cfgs(16)
    model = CPCModel(cp.cp_model_config(tmc))
    mesh = thread_meshes(1, "cpu")[0]
    z = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="distinct"):
        cp.cp_cpc_loss_and_metrics(model, z, mesh=mesh, dp_axis="ctx")
    with pytest.raises(ValueError, match="mesh has no 'model' axis"):
        cp.cp_cpc_loss_and_metrics(model, z, mesh=mesh, dp_axis="model")
    with pytest.raises(ValueError, match="built with attn_impl"):
        cp.cp_cpc_loss_and_metrics(CPCModel(_model_cfgs(16, "xla")[1]), z,
                                   mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        cp.shard(torch.zeros(3, 8), thread_meshes(2, "cpu")[0], "ctx",
                 "data")


# ---------------------------------------------------- the trainer and CLI
TINY = ["--config", "transformer_gar", "--data", "synthetic", "--device",
        "cpu", "--batch-size", "4", "--snippet-samples", "3200",
        "--set", "model.encoder.channels=8,8,8,8,8",
        "--set", "model.encoder.d_enc=8", "--set", "model.ar.d_ar=8",
        "--set", "model.ar.num_heads=2", "--set", "model.ar.num_layers=1",
        "--set", "model.loss.prediction_steps=2",
        "--set", "model.loss.negatives=all_steps",
        "--set", "train.parallel=cp"]


def _last_checkpoint(workdir):
    import glob
    path = sorted(glob.glob(str(workdir / "checkpoints" / "step_*.pt")))[-1]
    return torch.load(path)["model"]


def test_the_cli_trains_cp_and_resumes_bit_for_bit(tmp_path, capsys):
    straight, resumed = tmp_path / "a", tmp_path / "b"
    assert cli.main([*TINY, "--workdir", str(straight), "--steps", "3"]) == 0
    assert cli.main([*TINY, "--workdir", str(resumed), "--steps", "2"]) == 0
    assert cli.main([*TINY, "--workdir", str(resumed), "--steps", "3",
                     "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resume: restored step 2" in out
    import json
    rows = [json.loads(line) for line in
            (straight / "metrics.jsonl").read_text().splitlines()]
    assert rows and all(np.isfinite(r["loss"]) for r in rows
                        if "loss" in r)
    a, b = _last_checkpoint(straight), _last_checkpoint(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the checkpoint loads into the model of the config the run saved
    cfg = tcfg.from_dict(json.loads((straight / "config.json").read_text()))
    assert cfg.train.parallel == "cp"
    CPCModel(cfg.model).load_state_dict(a)


def _cli_processes(argv, n, timeout=600):
    """The training CLI as n gloo processes on the CPU (one without a
    coordinator); returns once all have exited 0."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "cpc_tpu_torch.train", *argv]
    cmds = [cmd] if n == 1 else [
        cmd + ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
               str(n), "--process-id", str(r)] for r in range(n)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(c, cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


@pytest.mark.slow
@pytest.mark.parametrize("parallel,extra", [
    ("cp", []),
    ("dpcp", ["--set", "train.mesh_shape=2,2", "--set",
              "train.mesh_axes=data,ctx"])])
def test_cli_on_four_gloo_processes_follows_one_process(parallel, extra,
                                                        tmp_path):
    """train.parallel cp (ctx 4) and dpcp (2 x 2) through the CLI on four
    gloo processes: the losses of 3 steps within 1e-5 of one process's
    ordinary step on the same batches."""
    import json
    base = [a if a != "train.parallel=cp" else "train.parallel=dp"
            for a in TINY] + ["--steps", "3", "--set", "train.log_every=1"]
    one, many = tmp_path / "one", tmp_path / parallel
    _cli_processes([*base, "--workdir", str(one)], 1)
    _cli_processes([*base, "--workdir", str(many), "--data",
                    str(one / "synthetic_corpus"), "--set",
                    f"train.parallel={parallel}", *extra], 4)

    def losses(wd):
        return [r["loss"] for r in map(json.loads, open(wd / "metrics.jsonl"))
                if r["prefix"] == "train"]
    assert len(losses(one)) == len(losses(many)) == 3
    np.testing.assert_allclose(losses(many), losses(one), rtol=1e-5)
