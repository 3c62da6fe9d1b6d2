"""Context parallelism for the transformer gar: the time axis sharded over
the ranks of a ring.

Port of `cpc_tpu/parallel/cp.py`. DP shards the batch, CP shards the
SEQUENCE: every op of the transformer but attention is per position, so
the gar runs on each rank's time shard with the parameters replicated,
and attention sweeps K/V chunks round the 'ctx' ring
(`ops/attention_ring.py`, `ops/attention_zigzag.py`). From raw audio the
conv encoder runs on the shard too, each layer swapping its halo with its
neighbours (`models/encoder.py::ConvEncoder._cp_forward`), and the loss is
the time-sharded all-steps InfoNCE on the same ring
(`ops/infonce_ring.py::ring_infonce_allsteps_ctx`). With `dp_axis` the
batch is sharded over 'data' as well (DP x CP): the InfoNCE ring runs over
the flattened (data, ctx) ranks, so negatives span the global pool.

Where the JAX functions take global arrays and shard them under
shard_map, these take THIS rank's shard (its rows of the batch along
'data', its span of the time axis along 'ctx') and return its shard of
the output, or the global loss and metrics, which every rank holds alike.
The mesh is a `parallel.mesh.ProcessMesh` (processes, or thread ranks of
`mesh.thread_meshes`); the gar's ring attention finds it through
`ops.ring_util.axis_env`, which these functions set. The model's gar must
be built with attn_impl 'ring' or 'zigzag' (`cp_model_config`: the
parameters are those of every attn_impl, so any checkpoint loads).

The training step (`make_cp_train_step`, `make_cp_step_fns`):

  * every rank gets the WHOLE global batch (the trainer stages it
    unsharded), prepares it (`device_prepare`, whose normalization spans
    the time axis) and augments it whole with the single-device step's
    draws (rank 0's `augment_generator`: its circular shift crosses the
    shards), then takes its shard: the CP step equals the single-device
    step by construction, as JAX's runs both outside its shard_map;
  * the loss is global (psum of the valid rows' nll over their count),
    so each rank's parameter gradient is a partial sum: the gradients are
    SUMMED over every rank (ctx, and data under 'dpcp'), in one fp32
    all_reduce, not averaged as data parallelism averages them;
  * grad_norm and the update follow, as in the single-device step.

Unlike the JAX trainer, 'cp' runs across processes and across hosts:
there each host feeds its own rows, so 'cp' (no batch axis) is refused
across hosts; here every rank, on any host, assembles the same seeded
global batch from the shared corpus, as JAX's devices of one process do,
and takes its shard of it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from cpc_tpu_torch.config import CPCConfig, ModelConfig
from cpc_tpu_torch.data.loader import device_prepare
from cpc_tpu_torch.ops.dsp import augment_waveform
from cpc_tpu_torch.ops.infonce_ring import ring_infonce_allsteps_ctx
from cpc_tpu_torch.ops.ring_util import axis_env
from cpc_tpu_torch.parallel.mesh import AXES, ProcessMesh, axis_sizes
from cpc_tpu_torch.utils.precision import exact_for

RING_IMPLS = ("ring", "zigzag")


def _ring_impl(attn_impl: str) -> str:
    """CP needs a ring-family attention: keep the user's 'zigzag', take
    'ring' for anything else."""
    return attn_impl if attn_impl in RING_IMPLS else "ring"


def cp_model_config(model_cfg: ModelConfig, axis: str = "ctx"
                    ) -> ModelConfig:
    """The model config a CP run builds its model from: attn_impl ring (or
    the user's zigzag) over `axis`; the parameters are the config's own."""
    ar = model_cfg.ar
    impl = _ring_impl(ar.attn_impl)
    if ar.attn_impl == impl and ar.cp_axis == axis:
        return model_cfg
    return dataclasses.replace(model_cfg, ar=dataclasses.replace(
        ar, attn_impl=impl, cp_axis=axis))


def _validate_cp_model(model_cfg: ModelConfig) -> None:
    if model_cfg.ar.kind != "transformer":
        raise ValueError(
            "context parallelism shards the transformer gar; the GRU's "
            "recurrence is inherently sequential (got ar.kind="
            f"{model_cfg.ar.kind!r})")
    if model_cfg.loss.negatives != "all_steps":
        raise ValueError(
            "the CP loss sweeps the all_steps pool by construction; set "
            f"loss.negatives='all_steps' (got {model_cfg.loss.negatives!r} "
            "— same_step has no time-sharded formulation: its candidates "
            "all live at one target step, i.e. on a single device)")


def _axis_size(mesh: ProcessMesh, axis: str) -> int:
    if axis not in AXES:
        raise ValueError(
            f"mesh has no {axis!r} axis (axes: {AXES}); build one with "
            f"ctx ranks or pass axis=... naming an existing mesh axis to "
            f"shard T over")
    return mesh.ring(axis).size


def _check_dp(mesh: ProcessMesh, dp_axis, axis: str) -> None:
    """Validates the optional data axis of a DP x CP call."""
    if dp_axis is None:
        return
    if dp_axis == axis:
        raise ValueError(
            f"dp_axis and the context axis must be distinct mesh axes "
            f"(both {axis!r})")
    _axis_size(mesh, dp_axis)


def _check_model(model) -> None:
    _validate_cp_model(model.config)
    if model.config.ar.attn_impl not in RING_IMPLS:
        raise ValueError(
            f"context parallelism needs the gar built with attn_impl "
            f"'ring' or 'zigzag', got {model.config.ar.attn_impl!r}: build "
            f"the model from cp_model_config(...) (same parameters)")


def cp_transformer_apply(gar, z: torch.Tensor, *, mesh: ProcessMesh,
                         axis: Optional[str] = None) -> torch.Tensor:
    """c = gar(z) with T sharded over `axis` (default: the gar's cp_axis).
    z: this rank's (B, T_loc, D) shard; returns its (B, T_loc, d_ar) shard.
    `gar` is a CausalTransformer built with attn_impl ring or zigzag."""
    axis = axis or gar.config.cp_axis
    if gar.config.attn_impl not in RING_IMPLS:
        raise ValueError(f"cp_transformer_apply needs attn_impl ring or "
                         f"zigzag, got {gar.config.attn_impl!r}")
    _axis_size(mesh, axis)
    with axis_env(mesh):
        return gar(z)


def _gar_heads_ctx_loss(model, z, mesh, axis, dp_axis=None):
    """The shared tail: gar (ring attention), the K heads on the local
    chunk, and the time-sharded all-steps InfoNCE on the same ring (the
    flattened (data, ctx) ring under dp_axis)."""
    with axis_env(mesh):
        c = model._gar(z, False, None)
    B, T_loc, _ = c.shape
    cfg = model.config
    preds = model.predict(c).reshape(B, T_loc, cfg.loss.prediction_steps,
                                     cfg.encoder.d_enc)
    return ring_infonce_allsteps_ctx(preds, z, mesh=mesh, axis_name=axis,
                                     data_axis=dp_axis)


def cp_cpc_loss_and_metrics(model, z: torch.Tensor, *, mesh: ProcessMesh,
                            axis: Optional[str] = None,
                            dp_axis: Optional[str] = None):
    """The CPC loss from latents, context-parallel: gar, heads, and the
    all-steps InfoNCE over the global pool, with z this rank's (B_loc,
    T_loc, D) shard. Returns (loss, metrics), global, differentiable with
    respect to the parameters and z; equal to the single-device
    infonce_loss_and_metrics(negatives='all_steps') on the whole arrays."""
    _check_model(model)
    axis = axis or model.config.ar.cp_axis
    _axis_size(mesh, axis)
    _check_dp(mesh, dp_axis, axis)
    return _gar_heads_ctx_loss(model, z, mesh, axis, dp_axis)


def cp_cpc_loss_from_audio(model, x: torch.Tensor, *, mesh: ProcessMesh,
                           axis: Optional[str] = None,
                           dp_axis: Optional[str] = None):
    """The whole CPC loss from raw audio, context-parallel: this rank's
    waveform shard (B_loc, S_loc) -> the conv encoder with a halo swap a
    layer -> gar (ring attention) -> heads -> the time-sharded all-steps
    InfoNCE. Returns the global (loss, metrics); equal to the single-device
    loss and gradients. S_loc must divide by prod(encoder.strides). With
    `dp_axis` the batch is sharded too and negatives span the global
    B_glob * T_glob pool. encoder.norm 'batch' takes its statistics over
    this rank's data row (its whole time axis), as JAX's does per data
    shard; the other norms equal the single-device ones."""
    _check_model(model)
    if model.config.encoder.kind != "conv1d":
        raise ValueError(
            "CP-from-audio shards the conv1d encoder with halo exchange; "
            f"encoder.kind={model.config.encoder.kind!r} (scalogram framing "
            "spans window boundaries — encode it data-parallel and use "
            "cp_cpc_loss_and_metrics on the latents)")
    axis = axis or model.config.ar.cp_axis
    _axis_size(mesh, axis)
    _check_dp(mesh, dp_axis, axis)
    z = model.encoder._cp_forward(x, mesh.ring(axis))
    return _gar_heads_ctx_loss(model, z, mesh, axis, dp_axis)


def shard(x: torch.Tensor, mesh: ProcessMesh, axis: str = "ctx",
          dp_axis: Optional[str] = None) -> torch.Tensor:
    """This rank's shard of a global (B, S, ...) array: its rows along
    `dp_axis` (all of them without one) and its span of axis 1 along
    `axis`."""
    ring = mesh.ring(axis)
    if x.shape[1] % ring.size:
        raise ValueError(f"length {x.shape[1]} not divisible by mesh axis "
                         f"{axis!r}={ring.size}")
    if dp_axis is not None:
        rows = mesh.ring(dp_axis)
        if x.shape[0] % rows.size:
            raise ValueError(f"batch {x.shape[0]} not divisible by mesh "
                             f"axis {dp_axis!r}={rows.size}")
        b = x.shape[0] // rows.size
        x = x[rows.index * b:(rows.index + 1) * b]
    s = x.shape[1] // ring.size
    return x[:, ring.index * s:(ring.index + 1) * s]


def cp_sizes(cfg: CPCConfig, world: int) -> Dict[str, int]:
    """{'data': n, 'ctx': m} of a 'cp' or 'dpcp' run over `world` ranks,
    from train.mesh_shape and mesh_axes ('cp' with the default axes
    ('data',) puts every rank on 'ctx', as the JAX trainer renames them)."""
    t = cfg.train
    axes = tuple(t.mesh_axes)
    if t.parallel == "cp" and axes == ("data",):
        axes = ("ctx",)
    if "model" in axes:
        raise ValueError(
            f"train.parallel={t.parallel!r} with a 'model' axis "
            f"(train.mesh_axes={axes}): tensor parallelism does not combine "
            f"with context parallelism, as in the JAX package; use "
            f"train.parallel='dp' (the model axis then holds replicas) or "
            f"parallel.tp.make_tp_train_step")
    sizes = axis_sizes(t.mesh_shape, axes, world)
    if t.parallel == "dpcp" and not set(AXES) <= set(axes):
        raise ValueError(
            "train.parallel='dpcp' needs a 2-D mesh with 'data' and 'ctx' "
            f"axes — set train.mesh_shape/mesh_axes (got axes {axes})")
    if t.parallel == "cp" and sizes["data"] != 1:
        raise ValueError(
            f"train.parallel='cp' shards time alone, but the mesh gives "
            f"'data' {sizes['data']} ranks; use 'dpcp'")
    if cfg.data.batch_size % sizes["data"]:
        raise ValueError(
            f"batch_size {cfg.data.batch_size} is not divisible by the "
            f"{sizes['data']}-way data axis; pass a compatible mesh= or "
            f"adjust data.batch_size")
    if cfg.data.snippet_samples % sizes["ctx"]:
        raise ValueError(
            f"data.snippet_samples {cfg.data.snippet_samples} is not "
            f"divisible by the {sizes['ctx']}-way ctx mesh axis — CP shards "
            f"the snippet's time axis; adjust snippet_samples or the mesh")
    return sizes


def check_cp_config(cfg: CPCConfig) -> None:
    """What a CP step cannot honour raises here, at build time, with the
    reason, never silently."""
    _validate_cp_model(cfg.model)
    if cfg.model.ar.dropout > 0:
        raise ValueError(
            "context-parallel training has no dropout path (ring/zigzag "
            "attention does not implement attention dropout, and the CP "
            "loss runner threads no rng); set model.ar.dropout=0.0")
    loss = cfg.model.loss
    # the CP loss is always the flattened-ring all_steps sweep: knobs that
    # would otherwise change behaviour raise rather than stop mattering
    ignored = [k for k, bad in (
        ("loss.cross_replica", not loss.cross_replica),  # CP is global
        ("loss.use_pallas", loss.use_pallas),
        ("loss.pallas_bf16", loss.pallas_bf16),
        ("loss.fuse_heads", loss.fuse_heads),
        ("loss.ring", loss.ring),  # implied; the DP selector is meaningless
    ) if bad]
    if ignored:
        raise ValueError(
            f"CP training always sweeps the global pool on the (dp, ctx) "
            f"ring; these settings would be silently ignored: {ignored} — "
            f"leave them at their defaults")
    if cfg.train.accum_steps > 1:
        raise ValueError(
            "make_cp_train_step does not implement gradient accumulation; "
            f"set train.accum_steps=1 (got {cfg.train.accum_steps})")
    if cfg.model.encoder.kind != "conv1d":
        raise ValueError(
            "CP-from-audio shards the conv1d encoder with halo exchange; "
            f"encoder.kind={cfg.model.encoder.kind!r}")


def resolve_mesh(cfg: CPCConfig, mesh: Optional[ProcessMesh],
                 device) -> ProcessMesh:
    """The (data, ctx) mesh of a CP run: a world of one without `mesh`;
    else `mesh` with its ctx axis from the config (a process mesh forms
    the row and column groups here, a collective every rank makes)."""
    if mesh is None:
        mesh = ProcessMesh(rank=0, size=1, device=torch.device(device))
    ctx = cp_sizes(cfg, mesh.size)["ctx"]
    if mesh.ctx == ctx:
        return mesh
    from cpc_tpu_torch.parallel.multihost import with_ctx
    return with_ctx(mesh, ctx)


def make_cp_train_step(cfg: CPCConfig, model, mesh: ProcessMesh, *,
                       axis: str = "ctx", dp_axis: Optional[str] = None):
    """The full CP (or DP x CP) training step from raw audio, and its
    optimizer: step(batch) takes the GLOBAL (B, S) batch (int16 wire or
    float; under data.device_corpus step(corpus, idx) with the global
    indices), prepares and augments it whole, runs this rank's shard
    through cp_cpc_loss_from_audio, sums the gradients over every rank and
    updates the model in place. Returns (step, optimizer); the step's
    metrics carry the global loss, per-k acc and grad_norm."""
    from cpc_tpu_torch.train.train_step import (_checked_backward,
                                                _nan_raise,
                                                augment_generator,
                                                make_optimizer)

    check_cp_config(cfg)
    _check_model(model)
    opt = make_optimizer(cfg, model)
    params = dict(model.named_parameters())
    world = mesh.ring(AXES)
    loss_fn = _loss_fn(cfg, model, mesh, axis, dp_axis)

    def step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        for p in params.values():
            p.grad = None
        aug = (augment_generator(cfg.train.seed, opt.count, 0, batch.device)
               if cfg.data.augment else None)
        nan_debug = torch.is_anomaly_enabled()
        # the backward runs in this thread: thread ranks' collectives, and
        # a remat recompute that reads the axis env; an fp32 model with
        # TF32 off
        with torch.autograd.set_multithreading_enabled(False), \
                axis_env(mesh), exact_for(model.dtype):
            loss, metrics = loss_fn(model, batch, augment=aug)
            if nan_debug:
                _checked_backward(loss, opt.count + 1)
            else:
                loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        grads = _summed({k: p.grad for k, p in params.items()}, world)
        metrics["grad_norm"] = opt.norm(grads)
        if nan_debug and not torch.isfinite(metrics["grad_norm"]):
            _nan_raise("gradient", opt.count + 1, "backward")
        opt.step(grads, norm=metrics["grad_norm"])
        return metrics

    if cfg.data.device_corpus:
        def corpus_step(corpus: torch.Tensor, idx: torch.Tensor):
            return step(corpus.index_select(0, idx))
        return corpus_step, opt
    return step, opt


def _loss_fn(cfg: CPCConfig, model, mesh, axis, dp_axis):
    d = cfg.data

    def loss_fn(model, batch: torch.Tensor, augment=None):
        """(loss, metrics) of the global batch, from this rank's shard."""
        x = device_prepare(batch, normalize=d.normalize)
        if augment is not None:
            x = augment_waveform(x, augment, gain_db=d.augment_gain_db,
                                 noise_snr_db=d.augment_noise_snr_db,
                                 shift_max=d.augment_shift_max)
        return cp_cpc_loss_from_audio(
            model, shard(x, mesh, axis, dp_axis), mesh=mesh, axis=axis,
            dp_axis=dp_axis)
    return loss_fn


def _summed(grads: Dict[str, torch.Tensor], ring) -> Dict[str, torch.Tensor]:
    """Each gradient summed over the ring's ranks: one fp32 all_reduce."""
    flat = torch.cat([g.reshape(-1).float() for g in grads.values()])
    ring.all_reduce(flat)
    out, at = {}, 0
    for k, g in grads.items():
        out[k] = flat[at:at + g.numel()].view(g.shape).to(g.dtype)
        at += g.numel()
    return out


def make_cp_step_fns(cfg: CPCConfig, model, mesh: Optional[ProcessMesh] = None):
    """Trainer-compatible StepFns for train.parallel 'cp' | 'dpcp' (the
    trainer builds these in place of the DP step's). train_step is
    make_cp_train_step's step, eval_step the same loss without gradients.
    Knobs this path cannot honour raise here, at build time."""
    from cpc_tpu_torch.train.train_step import StepFns

    check_cp_config(cfg)
    _check_model(model)
    device = next(model.parameters()).device
    mesh = resolve_mesh(cfg, mesh, device)
    dp_axis = "data" if cfg.train.parallel == "dpcp" else None
    axis = model.config.ar.cp_axis
    step, opt = make_cp_train_step(cfg, model, mesh, axis=axis,
                                   dp_axis=dp_axis)
    loss_fn = _loss_fn(cfg, model, mesh, axis, dp_axis)

    @torch.no_grad()
    def eval_step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        with axis_env(mesh), exact_for(model.dtype):
            return loss_fn(model, batch)[1]

    if cfg.data.device_corpus:
        batch_eval = eval_step

        def eval_step(corpus: torch.Tensor, idx: torch.Tensor):
            return batch_eval(corpus.index_select(0, idx))
    return StepFns(train_step=step, eval_step=eval_step, optimizer=opt,
                   loss_fn=loss_fn)
