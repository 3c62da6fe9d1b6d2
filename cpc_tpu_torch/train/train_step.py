"""The training and evaluation step, on one device or data-parallel.

Port of `cpc_tpu/train/train_step.py`: int16 dequantization and
normalization (`data.loader.device_prepare`), encoder, gar (GRU or causal
transformer), prediction heads, InfoNCE, backward, then Adam. PyTorch runs
eagerly, so the step is a plain function; the parameters are updated in
place, where the JAX step returns new ones.

`make_optimizer` is optax's chain with optax's numerics
(tests/test_torch_port_optim.py holds it against optax):
  * [clip_by_global_norm(c)]: g unchanged when ||g|| < c, else (g / ||g||) c,
    a select on the device, so the host never waits for the norm;
  * adam: mu, nu moments, bias correction 1 - b^count (in fp32) with count
    starting at 1, update mu_hat / (sqrt(nu_hat) + eps), eps outside the
    square root;
  * adamw: + weight_decay * param, after Adam and before the learning rate;
  * learning rate schedule(count) with its own count starting at 0, so with
    warmup the first update uses lr 0: optax's `linear_schedule` warmup for
    'constant', `warmup_cosine_decay_schedule` with decay_steps =
    max(num_steps, warmup + 1) for 'cosine'.
The count stays a host int (it is checkpointed); the host computes each
update's lr and bias corrections from it (`Optimizer.scalars`) and sends
them to the device as a row of fp32 tensors, which the update divides and
multiplies by: the eager step and a CUDA graph of it compute the same bits.
On a card the update is the kernel pair of `ops/adam_cuda.py`
(`csrc/adam_multi.cu`): the global norm from one sum-of-squares launch and
a finishing one, then one launch that clips and updates every leaf, in
place of some 17 launches a leaf; given the same norm it equals the tensor
code (`adam_multi_reference`) bit for bit. The path is the parameters'
device: the CPU runs the tensor code, leaf by leaf, and a card refuses
parameters or gradients that are not contiguous fp32 (the kernels' launch
counts say how often they ran). The step takes the norm once: its
grad_norm metric and the clip read the same tensor (`Optimizer.step`'s
`norm`).

`make_multi_step` chains N steps in one call (JAX's lax.scan over staged
batches): on a card one CUDA-graph replay of the N steps, their optimizer
scalars a device table of N rows and their generators re-seeded before
each replay; on the CPU the same steps one after another.

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

The step's phases are host spans (`utils.profiling.span`): `step.gather`
(a device corpus's rows), `step.forward` (the loss function: prepare,
encoder, gar, heads and InfoNCE, a mesh's pool gather) and `step.backward`
a microbatch, `step.average` under a mesh, and `step.optimizer` (grad_norm
and `Optimizer.step`, which holds `step.scalars`, the host's table of
scalars and its upload). They read the clock on the host alone and change
nothing the step computes or launches.

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
from typing import (Callable, Dict, Mapping, NamedTuple, Optional,
                    Tuple)

import torch
import torch.distributed as dist

from cpc_tpu_torch.config import CPCConfig, TrainConfig
from cpc_tpu_torch.data.loader import device_prepare
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.ops.adam_cuda import LeafTable, adam_multi_reference
from cpc_tpu_torch.ops.dsp import augment_waveform
from cpc_tpu_torch.ops.infonce import infonce_loss_and_metrics
from cpc_tpu_torch.ops.infonce_fused import fused_heads_infonce
from cpc_tpu_torch.ops.ring_util import ThreadGroup
from cpc_tpu_torch.parallel.dp import average, dp_eval_step, dp_train_step
from cpc_tpu_torch.parallel.mesh import axis_sizes, mesh_size
from cpc_tpu_torch.utils.precision import exact_for
from cpc_tpu_torch.utils.profiling import span


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
    `norm(grads)` is the clip's global norm: the sum-of-squares kernels on
    a card, `global_norm` elsewhere (`parallel/tp.py` sets its own over
    shards). A caller that took the norm for its metric passes it to `step`,
    which clips by that tensor. `step` reads nothing back from the device:
    the clip is a select there, and the per-step scalars are a row of
    `scalars`, so a CUDA graph can hold it (`make_multi_step`).

    The path is the parameters' device: on a card the kernel pair of
    `ops/adam_cuda.py` (`LeafTable`, which raises on parameters, gradients
    or scalars that are not contiguous fp32 on that card), elsewhere the
    tensor code (`adam_multi_reference`)."""

    def __init__(self, params: Mapping[str, torch.Tensor], t: TrainConfig):
        self.params = dict(params)
        self.device = next(iter(self.params.values())).device \
            if self.params else torch.device("cpu")
        self.schedule = make_schedule(t)
        self.b1, self.b2, self.eps = t.beta1, t.beta2, 1e-8
        self.weight_decay = t.weight_decay
        self.clip = t.grad_clip_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.table = LeafTable(self.params.values(), self.mu.values(),
                               self.nu.values(), **self._hyper()) \
            if self.device.type == "cuda" else None
        self.norm = self._norm

    def _hyper(self) -> Dict[str, float]:
        return {"b1": self.b1, "b2": self.b2, "eps": self.eps,
                "clip": self.clip, "weight_decay": self.weight_decay}

    def _norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        if self.table is None:
            return global_norm(grads.values())
        return self.table.norm([grads[k] for k in self.params])

    def scalars(self, count: int, n: int = 1) -> torch.Tensor:
        """(n, 3) fp32 on the parameters' device: row j holds the update at
        count + j's lr(count + j), 1 - b1**(count + j + 1) and
        1 - b2**(count + j + 1), computed on the host by optax's formulas
        (the bias corrections in fp32: b2 = 0.999 rounds to 0.99900001,
        which moves 1 - b2 by 1.3e-5 relative). On a card the table goes up
        from pinned memory without waiting for the device."""
        with span("step.scalars"):
            rows = [[self.schedule(c)]
                    + [float(1.0 - torch.tensor(b, dtype=torch.float32)
                             ** (c + 1)) for b in (self.b1, self.b2)]
                    for c in range(count, count + n)]
            table = torch.tensor(rows, dtype=torch.float32)
            if self.device.type == "cuda":
                return table.pin_memory().to(self.device, non_blocking=True)
            return table.to(self.device)

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor],
             scalars: Optional[torch.Tensor] = None,
             norm: Optional[torch.Tensor] = None) -> None:
        """One update. `scalars` is its row of `scalars()` on the device
        (a CUDA graph's table); by default the row of `count`. `norm` is
        the gradients' global norm if the caller took it, else the clip
        takes `norm(grads)`."""
        if scalars is None:
            scalars = self.scalars(self.count)[0]
        if self.clip > 0 and norm is None:
            norm = self.norm(grads)
        gs = [grads[k] for k in self.params]
        if self.table is None:
            adam_multi_reference(self.params.values(), gs, self.mu.values(),
                                 self.nu.values(), scalars, norm,
                                 **self._hyper())
        else:
            self.table.update(gs, scalars, norm)
        self.count += 1

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


def dropout_seed(seed: int, count: int, microbatch: int,
                 rank: int = 0) -> int:
    """The seed of the dropout draws of microbatch `microbatch` of
    optimizer step `count` on rank `rank`: a function of (train.seed,
    count, microbatch, rank) alone. Rank 0 draws what a single-device run
    draws."""
    mixed = (seed * 0x9E3779B97F4A7C15 + count * 1_000_003 + microbatch
             + rank * 0xD1B54A32D192ED03)
    return mixed % (1 << 63)


def augment_seed(seed: int, count: int, microbatch: int,
                 rank: int = 0) -> int:
    """The seed of the augmentation draws, as `dropout_seed` by another
    mix, so the two streams differ."""
    mixed = ((seed + 0x5EED) * 0xBF58476D1CE4E5B9 + count * 2_000_029
             + microbatch * 7_919 + rank * 0x94D049BB133111EB)
    return mixed % (1 << 63)


def dropout_generator(seed: int, count: int, microbatch: int, device,
                      rank: int = 0) -> torch.Generator:
    """A generator on `device` seeded by `dropout_seed`."""
    return torch.Generator(device=device).manual_seed(
        dropout_seed(seed, count, microbatch, rank))


def augment_generator(seed: int, count: int, microbatch: int, device,
                      rank: int = 0) -> torch.Generator:
    """A generator on `device` seeded by `augment_seed`."""
    return torch.Generator(device=device).manual_seed(
        augment_seed(seed, count, microbatch, rank))


def uses_dropout(cfg: CPCConfig) -> bool:
    """Whether the training step draws dropout masks (a transformer gar
    with ar.dropout > 0)."""
    return cfg.model.ar.kind == "transformer" and cfg.model.ar.dropout > 0


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
    dropout = uses_dropout(cfg)
    d = cfg.data
    seed = cfg.train.seed

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

    def train_step(batch: torch.Tensor, mesh=None, *,
                   scalars: Optional[torch.Tensor] = None,
                   generators=None) -> Dict[str, torch.Tensor]:
        """One optimizer step. With accum_steps > 1 the batch splits into
        microbatches, each its own negative pool; grads and metrics are
        averaged, and then over the ranks of `mesh`. Metrics stay on the
        device (reading them syncs); p.grad keeps this rank's sum of its
        microbatches' gradients. An fp32 model steps with TF32 off.
        `scalars` (the optimizer's row of `Optimizer.scalars`) and
        `generators` (a (dropout, augment) pair a microbatch, seeded as
        `dropout_generator` / `augment_generator` seed theirs) are what a
        CUDA graph of the step takes from outside (`make_multi_step`); by
        default both come from the optimizer's count."""
        with exact_for(model.dtype):
            return _train_step(batch, mesh, scalars, generators)

    def _train_step(batch: torch.Tensor, mesh, scalars,
                    generators) -> Dict[str, torch.Tensor]:
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
            if generators is not None:
                gen, aug = generators[i]
            else:
                gen = dropout_generator(seed, opt.count, i, batch.device,
                                        rank) if dropout else None
                aug = augment_generator(seed, opt.count, i, batch.device,
                                        rank) if d.augment else None
            with span("step.forward"):
                loss, metrics = loss_fn(model, mb, gen, mesh, aug)
            with span("step.backward"):
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
            with span("step.average"):
                grads, metrics = _averaged(grads, metrics, mesh)
        with span("step.optimizer"):
            metrics["grad_norm"] = opt.norm(grads)
            if nan_debug and not torch.isfinite(metrics["grad_norm"]):
                _nan_raise("gradient", opt.count + 1, "backward")
            opt.step(grads, scalars, norm=metrics["grad_norm"])
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
            with span("step.gather"):
                rows = corpus.index_select(0, idx)
            return batch_train(rows, mesh)

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


#: eager steps a MultiStep runs on a side stream before its capture
WARMUP_STEPS = 2


def make_multi_step(cfg: CPCConfig, model: CPCModel, n_steps: int,
                    mesh=None) -> Tuple["MultiStep", StepFns]:
    """(multi, steps): `n_steps` training steps in one call, and the step
    functions they chain (`make_step_fns`). `multi(batches)` takes an int16
    (n_steps, B, S) stack on the model's device, updates the model and the
    optimizer in place as n_steps calls of `steps.train_step` would, and
    returns the last step's loss. On a card the steps run as one CUDA-graph
    replay (`MultiStep`); on the CPU the same steps run one after another.

    Port of `cpc_tpu/train/train_step.py::make_multi_step`, which chains the
    steps inside one jit with `lax.scan`. The port's steps seed their
    dropout and augmentation draws from train.seed and the optimizer's
    count, so `multi` takes no rng. Raises ValueError where JAX raises
    (`data.device_corpus`) and where a capture cannot hold the step:
    train.parallel 'cp' / 'dpcp', tensor parallelism or a 'model' axis, a
    mesh of thread ranks or of gloo processes (only NCCL's collectives are
    captured), the transformer's remat with dropout (its replay reads the
    generator's state on the host) and nan-debug."""
    if cfg.data.device_corpus:
        raise ValueError(
            "make_multi_step takes pre-staged BATCHES; data.device_corpus "
            "steps take (corpus, idx) instead — stage batches device-side "
            "yourself (they already avoid per-step transfers) or drop the "
            "flag")
    t = cfg.train
    if t.parallel != "dp":
        raise ValueError(f"make_multi_step runs train.parallel 'dp', not "
                         f"{t.parallel!r}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    world = 1 if mesh is None else mesh.size
    if getattr(model, "tp_shards", None) is not None or \
            axis_sizes(t.mesh_shape, t.mesh_axes, world)["model"] > 1 or \
            (mesh is not None and mesh.model > 1):
        raise ValueError("make_multi_step does not capture tensor "
                         "parallelism or a 'model' axis")
    if mesh is not None:
        if isinstance(mesh.group, ThreadGroup):
            raise ValueError("make_multi_step cannot capture the "
                             "collectives of thread ranks")
        backend = dist.get_backend(mesh.group)
        if backend != "nccl":
            raise ValueError(f"make_multi_step captures NCCL's collectives, "
                             f"not {backend!r}'s")
    if uses_dropout(cfg) and cfg.model.ar.remat:
        raise ValueError("make_multi_step cannot capture ar.remat with "
                         "dropout: the recompute restores its generator's "
                         "state from the host")
    _refuse_nan_debug()
    steps = make_step_fns(cfg, model, mesh)
    return MultiStep(cfg, model, n_steps, steps, mesh), steps


def _refuse_nan_debug() -> None:
    if torch.is_anomaly_enabled():
        raise ValueError("make_multi_step does not run under nan-debug "
                         "(autograd's anomaly mode checks values on the "
                         "host)")


class MultiStep:
    """`n_steps` training steps of `steps.train_step` as one call.

    Each call writes the steps' optimizer scalars into a device table
    (`Optimizer.scalars`, one row a step) and re-seeds a generator pair a
    step and microbatch with the seeds the eager step would draw from
    (`dropout_seed`, `augment_seed` of count + j), then runs the steps with
    them. On a card the first call runs WARMUP_STEPS eager steps on a side
    stream (`warm_up`: they build the kernels' library, cuBLAS's and NCCL's
    state; the model and the optimizer are put back), then captures the
    n_steps steps, unrolled, into one `torch.cuda.CUDAGraph` over a static
    batch buffer (`capture`), and every call replays it: the graph holds
    the kernels, the collectives of an NCCL mesh and the optimizer, and
    its generators are registered with it, so a replay draws from the
    seeds of that call. A capture or a replay that fails raises. The count
    advances by n_steps on the host. The parameters and moments are
    captured by address: load a checkpoint in place (`load_state_dict`),
    never by replacing the tensors."""

    def __init__(self, cfg: CPCConfig, model: CPCModel, n_steps: int,
                 steps: StepFns, mesh=None):
        self.n = n_steps
        self.steps = steps
        self.opt = steps.optimizer
        self.model = model
        self.device = self.opt.device
        self.accum = cfg.train.accum_steps
        self.seed = cfg.train.seed
        self.rank = 0 if mesh is None else mesh.data_mesh().rank
        self.shape = None  # the batch stack's, fixed by the first call
        self.graph = None
        self._static = self._table = self._loss = self._stream = None

        def gen(on: bool):
            return torch.Generator(device=self.device) if on else None
        self.generators = [[(gen(uses_dropout(cfg)), gen(cfg.data.augment))
                            for _ in range(self.accum)]
                           for _ in range(n_steps)]

    def __call__(self, batches: torch.Tensor) -> torch.Tensor:
        self._check(batches)
        count = self.opt.count
        self._reseed(count)
        table = self.opt.scalars(count, self.n)
        if self.device.type != "cuda":
            loss = self._steps(batches, table)
        else:
            if self.graph is None:
                self.warm_up(batches)
                self.capture(batches)
            self._table.copy_(table)
            self._static.copy_(batches)
            self.graph.replay()
            loss = self._loss.clone()
        self.opt.count = count + self.n
        return loss

    def _check(self, batches: torch.Tensor) -> None:
        _refuse_nan_debug()
        if not isinstance(batches, torch.Tensor) or \
                batches.dtype != torch.int16 or batches.dim() != 3 or \
                batches.shape[0] != self.n:
            raise ValueError(
                f"multi takes an int16 ({self.n}, B, S) stack of batches, got "
                f"{getattr(batches, 'dtype', type(batches))} "
                f"{tuple(getattr(batches, 'shape', ()))}")
        if batches.device != self.device:
            raise ValueError(f"the batches are on {batches.device}, the "
                             f"model on {self.device}")
        if self.shape is None:
            if batches.shape[1] % self.accum:
                raise ValueError(f"batch {batches.shape[1]} is not divisible "
                                 f"by accum_steps {self.accum}")
            self.shape = batches.shape
        elif batches.shape != self.shape:
            raise ValueError(f"multi was captured for batch stacks of "
                             f"{tuple(self.shape)}, got "
                             f"{tuple(batches.shape)}")

    def _reseed(self, count: int) -> None:
        for j, pairs in enumerate(self.generators):
            for i, (gen, aug) in enumerate(pairs):
                if gen is not None:
                    gen.manual_seed(dropout_seed(self.seed, count + j, i,
                                                 self.rank))
                if aug is not None:
                    aug.manual_seed(augment_seed(self.seed, count + j, i,
                                                 self.rank))

    def _steps(self, batches: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
        """The steps, one after another: run as they are on the CPU,
        captured on a card."""
        for j in range(self.n):
            metrics = self.steps.train_step(batches[j], scalars=table[j],
                                            generators=self.generators[j])
        return metrics["loss"]

    def _state(self):
        return (list(self.model.parameters()) + list(self.opt.mu.values())
                + list(self.opt.nu.values()))

    @torch.no_grad()
    def _restore(self, saved) -> None:
        for t, v in zip(self._state(), saved):
            t.copy_(v)

    def warm_up(self, batches: torch.Tensor) -> None:
        """WARMUP_STEPS eager steps on the capture's side stream; the
        model, the moments and the count are put back as they were."""
        self._check(batches)
        saved = [t.detach().clone() for t in self._state()]
        count = self.opt.count
        current = torch.cuda.current_stream(self.device)
        stream = self._side_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for j in range(WARMUP_STEPS):
                self.steps.train_step(batches[j % self.n])
            self._restore(saved)
        current.wait_stream(stream)
        self.opt.count = count

    def capture(self, batches: torch.Tensor) -> None:
        """Captures the n_steps steps over a static copy of `batches` and a
        device table of scalars into `self.graph` (nothing runs)."""
        self._check(batches)
        self._static = batches.clone()
        self._table = torch.zeros((self.n, 3), dtype=torch.float32,
                                  device=self.device)
        graph = torch.cuda.CUDAGraph()
        for pairs in self.generators:
            for g in (g for pair in pairs for g in pair if g is not None):
                graph.register_generator_state(g)
        count = self.opt.count
        current = torch.cuda.current_stream(self.device)
        stream = self._side_stream()
        stream.wait_stream(current)
        # thread_local: other threads of the process (NCCL's watchdog, a
        # batch feed) go on while this one captures
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            self._loss = self._steps(self._static, self._table)
        current.wait_stream(stream)
        self.opt.count = count
        self.graph = graph

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream
