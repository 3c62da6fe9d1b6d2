"""The training and evaluation step, on one device or data-parallel.

Port of `cpc_tpu/train/train_step.py`: int16 dequantization and
normalization (`data.loader.device_prepare`), encoder, gar (GRU or causal
transformer), prediction heads, InfoNCE, backward, then Adam. PyTorch runs
eagerly, so the step is a plain function; the parameters are updated in
place, where the JAX step returns new ones.

`make_optimizer` is optax's chain written out in tensor code, with optax's
numerics (tests/test_torch_port_optim.py holds it against optax):
  * [clip_by_global_norm(c)]: g unchanged when ||g|| < c, else (g / ||g||) c;
  * adam: mu, nu moments, bias correction 1 - b^count (in fp32) with count
    starting at 1, update mu_hat / (sqrt(nu_hat) + eps), eps outside the
    square root;
  * adamw: + weight_decay * param, after Adam and before the learning rate;
  * learning rate schedule(count) with its own count starting at 0, so with
    warmup the first update uses lr 0: optax's `linear_schedule` warmup for
    'constant', `warmup_cosine_decay_schedule` with decay_steps =
    max(num_steps, warmup + 1) for 'cosine'.

Transformer dropout (`ar.dropout > 0`) draws from a `torch.Generator` made
anew for every microbatch of every step and seeded from `train.seed` and
the optimizer's step count (`dropout_generator`), as the JAX trainer folds
the step into its key, and from the rank, as the JAX step folds in
`axis_index`. The count is part of the checkpoint, so a resumed run draws
what the straight run draws. Evaluation never drops. On-device augmentation
(`data.augment`, `ops.dsp.augment_waveform`, after `prepare_waveform`)
draws from a generator of its own, seeded the same way by another formula
(`augment_generator`), so that turning it on leaves the dropout draws as
they were; evaluation never augments.

With `data.device_corpus` the steps take `(corpus, idx)`: the (N, S)
int16 corpus on the device and this step's (B,) snippet indices, and
gather the batch's rows there; the rest of the step is the same.

Under nan-debug (`utils.profiling.enable_nan_debug`, which turns on
autograd's anomaly mode) the train step checks its loss after the forward
and its gradients after the backward, and raises FloatingPointError at the
first non-finite value, naming the step and the pass.

With a `mesh` (`parallel.mesh.ProcessMesh`) the step is data-parallel, as
`cpc_tpu/parallel/dp.py` has it: each rank steps on its rows of the global
batch, gathers the latents of every rank into its candidate pool when
`loss.cross_replica` (each microbatch its own gathered pool), and averages
gradients and metrics over the ranks before grad_norm and the update, so
the update is the single-device step on the global batch. A mesh of one
rank runs the same collectives. With `loss.ring` the all-steps pool is
swept round the ranks instead of gathered (`ops/infonce_ring.py`).
`train.parallel` 'cp' and 'dpcp' build the context-parallel steps of
`parallel/cp.py` instead. A 'model' axis under 'dp' holds replicas
(`dp_mesh`): each data row's ranks step on the same rows, and the pool's
gather and the averages run over the data axis alone; tensor parallelism
proper is `parallel/tp.py::make_tp_train_step`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple, Tuple

import torch

from cpc_tpu_torch.config import CPCConfig, TrainConfig
from cpc_tpu_torch.data.loader import device_prepare
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.ops.dsp import augment_waveform
from cpc_tpu_torch.ops.infonce import infonce_loss_and_metrics
from cpc_tpu_torch.ops.infonce_fused import fused_heads_infonce
from cpc_tpu_torch.parallel.dp import average, dp_eval_step, dp_train_step
from cpc_tpu_torch.parallel.mesh import axis_sizes, mesh_size
from cpc_tpu_torch.utils.precision import exact_for


class StepFns(NamedTuple):
    # batch -> metrics, or (corpus, idx) -> metrics under data.device_corpus
    train_step: Callable  # updates the model in place
    eval_step: Callable
    optimizer: "Optimizer"
    loss_fn: Callable     # (model, batch) -> (loss, metrics)


def make_schedule(t: TrainConfig) -> Callable[[int], float]:
    """Learning rate at schedule count n = 0, 1, ... (optax's schedules)."""
    lr, w = t.learning_rate, t.warmup_steps
    if t.lr_schedule == "constant":
        if w <= 0:
            return lambda n: lr
        return lambda n: lr * min(max(n, 0), w) / w  # linear_schedule(0, lr, w)
    if t.lr_schedule == "cosine":
        decay = max(t.num_steps, w + 1) - w

        def cosine(n):
            if n < w:  # warmup from 0 (w > 0 here)
                return lr * n / w
            m = min(n - w, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * m / decay))
        return cosine
    raise ValueError(f"unknown lr_schedule {t.lr_schedule!r} "
                     "(expected 'constant' | 'cosine')")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in fp32 (optax's
    global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class Optimizer:
    """[clip_by_global_norm] -> Adam or AdamW -> -lr(count), over the fp32
    parameters `params` (name -> tensor), updated in place by `step`.
    `norm(grads)` is the clip's global norm: `global_norm` of the values
    (`parallel/tp.py` sets its own over shards)."""

    def __init__(self, params: Mapping[str, torch.Tensor], t: TrainConfig):
        self.params = dict(params)
        self.norm = lambda grads: global_norm(grads.values())
        self.schedule = make_schedule(t)
        self.b1, self.b2, self.eps = t.beta1, t.beta2, 1e-8
        self.weight_decay = t.weight_decay
        self.clip = t.grad_clip_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        if self.clip > 0:
            norm = self.norm(grads)
            if not norm < self.clip:
                grads = {k: g / norm * self.clip for k, g in grads.items()}
        lr = self.schedule(self.count)
        count = self.count + 1
        # 1 - b**count in fp32, as optax computes it (b2 = 0.999 rounds to
        # 0.99900001 in fp32, which moves 1 - b2 by 1.3e-5 relative)
        bc1, bc2 = (float(1.0 - torch.tensor(b, dtype=torch.float32) ** count)
                    for b in (self.b1, self.b2))
        for k, p in self.params.items():
            g = grads[k]
            mu = self.mu[k].mul_(self.b1).add_((1.0 - self.b1) * g)
            nu = self.nu[k].mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay > 0:
                u = u + self.weight_decay * p
            p.add_(-lr * u)
        self.count = count

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: Mapping) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for name in ("mu", "nu"):
                for k, v in getattr(self, name).items():
                    v.copy_(state[name][k])


def make_optimizer(cfg: CPCConfig, model: torch.nn.Module) -> Optimizer:
    return Optimizer(dict(model.named_parameters()), cfg.train)


def resolve_fuse_heads(cfg: CPCConfig, mesh=None) -> bool:
    """The loss-path chooser. The CUDA kernels sweep the candidate pool in
    column tiles, so nothing bounds C, the gathered pool of a mesh
    included, and the JAX package's v5e envelope (C <= 128, a Mosaic VMEM
    fact) does not carry over: the fused path runs whenever it is asked
    for. `mesh` is taken as the JAX chooser takes it."""
    loss = cfg.model.loss
    return loss.use_pallas and loss.fuse_heads and \
        loss.negatives == "same_step"


def check_supported(cfg: CPCConfig, mesh=None) -> None:
    """Raises on what the port's data-parallel trainer does not run, and
    on a mesh or batch that does not fit the world of `mesh` (one process
    without one)."""
    t, d = cfg.train, cfg.data
    if t.parallel not in ("dp", "cp", "dpcp"):
        raise ValueError(f"train.parallel must be 'dp'|'cp'|'dpcp', "
                         f"got {t.parallel!r}")
    world = 1 if mesh is None else mesh.size
    mesh_size(t.mesh_shape, world, t.mesh_axes)
    if "ctx" in t.mesh_axes:
        raise ValueError(
            f"train.mesh_axes={tuple(t.mesh_axes)} under train.parallel="
            f"'dp': a 'ctx' axis needs train.parallel 'dpcp'")
    # the rows split over 'data' alone: a 'model' axis's ranks are replicas
    data = world // axis_sizes(t.mesh_shape, t.mesh_axes, world)["model"]
    if d.batch_size % data:
        raise ValueError(
            f"batch_size {d.batch_size} is not divisible by the {data}-way "
            f"data axis; pass a compatible mesh= or adjust data.batch_size")
    if t.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {t.accum_steps}")


def dp_mesh(cfg: CPCConfig, mesh):
    """`mesh` with the 'model' axis that train.mesh_shape / mesh_axes name
    under train.parallel 'dp' (None without a mesh): its ranks hold
    replicas of the model, as the JAX trainer runs a ('data', 'model')
    mesh's data-parallel step over 'data', so each data row's ranks step on
    the same rows and the DP collectives run over the data axis alone
    (`ProcessMesh.data_mesh`). A process mesh forms its groups here, a
    collective every rank makes."""
    if mesh is None:
        return None
    t = cfg.train
    model = axis_sizes(t.mesh_shape, t.mesh_axes, mesh.size)["model"]
    if mesh.model == model:
        return mesh
    from cpc_tpu_torch.parallel.multihost import with_model
    return with_model(mesh, model)


def init_state(cfg: CPCConfig, device=None) -> CPCModel:
    """The model, its weights drawn from `train.seed` (on the CPU, so a seed
    gives the same weights on any device), on `device`. Under
    train.parallel 'cp' | 'dpcp' its gar takes a ring attention
    (`parallel.cp.cp_model_config`: the same parameters and draws)."""
    model_cfg = cfg.model
    if cfg.train.parallel != "dp":
        from cpc_tpu_torch.parallel.cp import cp_model_config
        model_cfg = cp_model_config(model_cfg)
    return CPCModel(model_cfg, device=device,
                    generator=torch.Generator().manual_seed(cfg.train.seed))


def dropout_generator(seed: int, count: int, microbatch: int, device,
                      rank: int = 0) -> torch.Generator:
    """The dropout draws of microbatch `microbatch` of optimizer step
    `count` on rank `rank`: a function of (train.seed, count, microbatch,
    rank) alone. Rank 0 draws what a single-device run draws."""
    mixed = (seed * 0x9E3779B97F4A7C15 + count * 1_000_003 + microbatch
             + rank * 0xD1B54A32D192ED03)
    return torch.Generator(device=device).manual_seed(mixed % (1 << 63))


def augment_generator(seed: int, count: int, microbatch: int, device,
                      rank: int = 0) -> torch.Generator:
    """The augmentation draws of microbatch `microbatch` of optimizer step
    `count` on rank `rank`: a function of (train.seed, count, microbatch,
    rank) alone, by another mix than `dropout_generator`'s, so the two
    streams differ."""
    mixed = ((seed + 0x5EED) * 0xBF58476D1CE4E5B9 + count * 2_000_029
             + microbatch * 7_919 + rank * 0x94D049BB133111EB)
    return torch.Generator(device=device).manual_seed(mixed % (1 << 63))


def _nan_raise(what: str, step: int, where: str) -> None:
    raise FloatingPointError(f"nan-debug: non-finite {what} at step {step}, "
                             f"in the {where}")


def _checked_backward(loss: torch.Tensor, step: int) -> None:
    """loss.backward() under nan-debug: a non-finite loss raises before it,
    and anomaly mode's NaN report from a backward function raises as
    FloatingPointError."""
    if not torch.isfinite(loss):
        _nan_raise("loss", step, "forward")
    try:
        loss.backward()
    except RuntimeError as e:
        if "nan" not in str(e).lower():
            raise
        raise FloatingPointError(f"nan-debug: non-finite value at step "
                                 f"{step}, in the backward: {e}") from e


def make_step_fns(cfg: CPCConfig, model: CPCModel, mesh=None) -> StepFns:
    """The train and eval steps of `model`; with a `mesh`, data-parallel
    over its ranks (each step takes this rank's rows). Under
    train.parallel 'cp' | 'dpcp' the context-parallel steps of
    `parallel.cp.make_cp_step_fns` (each takes the global batch)."""
    if cfg.train.parallel in ("cp", "dpcp"):
        from cpc_tpu_torch.parallel.cp import make_cp_step_fns
        return make_cp_step_fns(cfg, model, mesh)
    check_supported(cfg, mesh)
    mesh = dp_mesh(cfg, mesh)
    opt = make_optimizer(cfg, model)
    loss_cfg = cfg.model.loss
    normalize = cfg.data.normalize
    fuse_heads = resolve_fuse_heads(cfg, mesh)
    accum = cfg.train.accum_steps
    params = dict(model.named_parameters())
    dropout = cfg.model.ar.kind == "transformer" and cfg.model.ar.dropout > 0
    d = cfg.data

    def loss_fn(model: CPCModel, batch: torch.Tensor, generator=None,
                mesh=None, augment=None):
        """(loss, metrics). With a `generator` (and ar.dropout > 0) the
        transformer's dropout is live and draws from it; with an `augment`
        generator the prepared waveform is augmented with its draws; with a
        `mesh` and loss.cross_replica the candidate pool is every rank's
        latents."""
        x = device_prepare(batch, normalize=normalize)
        if augment is not None:
            x = augment_waveform(x, augment, gain_db=d.augment_gain_db,
                                 noise_snr_db=d.augment_noise_snr_db,
                                 shift_max=d.augment_shift_max)
        train = dropout and generator is not None
        pool_mesh = mesh if loss_cfg.cross_replica else None
        if fuse_heads:
            z, c_tm = model.latents_tm(x, train, generator)
            W = model.prediction_heads.weight.t()  # (d_ar, K*d_enc)
            kdtype = torch.bfloat16 if loss_cfg.pallas_bf16 else torch.float32
            return fused_heads_infonce(
                c_tm, z, W, num_steps=loss_cfg.prediction_steps,
                compute_dtype=kdtype, c_time_major=True, mesh=pool_mesh)
        out = model(x, train, generator)
        return infonce_loss_and_metrics(
            out.preds, out.z, negatives=loss_cfg.negatives, mesh=pool_mesh,
            use_pallas=loss_cfg.use_pallas,
            pallas_bf16=loss_cfg.pallas_bf16, ring=loss_cfg.ring)

    def train_step(batch: torch.Tensor, mesh=None) -> Dict[str, torch.Tensor]:
        """One optimizer step. With accum_steps > 1 the batch splits into
        microbatches, each its own negative pool; grads and metrics are
        averaged, and then over the ranks of `mesh`. Metrics stay on the
        device (reading them syncs); p.grad keeps this rank's sum of its
        microbatches' gradients. An fp32 model steps with TF32 off."""
        with exact_for(model.dtype):
            return _train_step(batch, mesh)

    def _train_step(batch: torch.Tensor, mesh) -> Dict[str, torch.Tensor]:
        B = batch.shape[0]
        if B % accum:
            raise ValueError(
                f"batch {B} is not divisible by accum_steps {accum}")
        for p in params.values():
            p.grad = None
        rank = 0 if mesh is None else mesh.rank
        nan_debug = torch.is_anomaly_enabled()
        per_mb = []
        mbs = batch.reshape(accum, B // accum, *batch.shape[1:])
        for i, mb in enumerate(mbs):
            gen = dropout_generator(cfg.train.seed, opt.count, i,
                                    batch.device, rank) if dropout else None
            aug = augment_generator(cfg.train.seed, opt.count, i,
                                    batch.device, rank) if d.augment else None
            loss, metrics = loss_fn(model, mb, gen, mesh, aug)
            if nan_debug:
                _checked_backward(loss, opt.count + 1)
            else:
                loss.backward()
            per_mb.append({k: v.detach() for k, v in metrics.items()})
        grads = {k: p.grad for k, p in params.items()}
        if accum > 1:
            grads = {k: g / accum for k, g in grads.items()}
        metrics = {k: torch.stack([m[k] for m in per_mb]).mean(0)
                   for k in per_mb[0]}
        if mesh is not None:
            grads, metrics = _averaged(grads, metrics, mesh)
        metrics["grad_norm"] = global_norm(grads.values())
        if nan_debug and not torch.isfinite(metrics["grad_norm"]):
            _nan_raise("gradient", opt.count + 1, "backward")
        opt.step(grads)
        return metrics

    @torch.no_grad()
    def eval_step(batch: torch.Tensor, mesh=None) -> Dict[str, torch.Tensor]:
        with exact_for(model.dtype):
            metrics = loss_fn(model, batch, mesh=mesh)[1]
        if mesh is not None:
            metrics = _averaged({}, metrics, mesh)[1]
        return metrics

    if d.device_corpus:
        batch_train, batch_eval = train_step, eval_step

        def train_step(corpus: torch.Tensor, idx: torch.Tensor, mesh=None):
            return batch_train(corpus.index_select(0, idx), mesh)

        def eval_step(corpus: torch.Tensor, idx: torch.Tensor, mesh=None):
            return batch_eval(corpus.index_select(0, idx), mesh)

    if mesh is not None:
        train_step = dp_train_step(train_step, mesh.data_mesh())
        eval_step = dp_eval_step(eval_step, mesh.data_mesh())
    return StepFns(train_step=train_step, eval_step=eval_step, optimizer=opt,
                   loss_fn=loss_fn)


def _averaged(grads: Dict[str, torch.Tensor], metrics: Dict[str, torch.Tensor],
              mesh) -> Tuple[Dict[str, torch.Tensor],
                             Dict[str, torch.Tensor]]:
    """grads and metrics averaged over the ranks, in one all_reduce."""
    names = list(grads) + list(metrics)
    means = average(list(grads.values()) + list(metrics.values()), mesh)
    out = dict(zip(names, means))
    return ({k: out[k] for k in grads}, {k: out[k] for k in metrics})
