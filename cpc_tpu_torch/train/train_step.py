"""The training and evaluation step, on one device.

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
the step into its key. The count is part of the checkpoint, so a resumed
run draws what the straight run draws. Evaluation never drops.

Single device only: a mesh, data or context parallelism, `device_corpus` and
`augment` raise, naming their ROADMAP.md items.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple

import torch

from cpc_tpu_torch.config import CPCConfig, TrainConfig
from cpc_tpu_torch.data.loader import device_prepare
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.ops.infonce import infonce_loss_and_metrics
from cpc_tpu_torch.ops.infonce_fused import fused_heads_infonce


class StepFns(NamedTuple):
    train_step: Callable  # batch -> metrics; updates the model in place
    eval_step: Callable   # batch -> metrics
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
    parameters `params` (name -> tensor), updated in place by `step`."""

    def __init__(self, params: Mapping[str, torch.Tensor], t: TrainConfig):
        self.params = dict(params)
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
            norm = global_norm(grads.values())
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


def resolve_fuse_heads(cfg: CPCConfig) -> bool:
    """The loss-path chooser. The CUDA kernels sweep the candidate pool in
    column tiles, so nothing bounds C, and the JAX package's v5e envelope
    (C <= 128, a Mosaic VMEM fact) does not carry over: the fused path runs
    whenever it is asked for."""
    loss = cfg.model.loss
    return loss.use_pallas and loss.fuse_heads and \
        loss.negatives == "same_step"


def check_supported(cfg: CPCConfig) -> None:
    """Raises on what the port's single-device trainer does not run yet."""
    t, d = cfg.train, cfg.data
    if t.parallel != "dp" or tuple(t.mesh_shape) not in ((-1,), (1,)):
        raise NotImplementedError(
            f"train.parallel={t.parallel!r}, mesh_shape={t.mesh_shape}: the "
            f"port trains on one device; data, context and tensor "
            f"parallelism are ROADMAP.md §A13")
    if d.device_corpus:
        raise NotImplementedError("data.device_corpus is not ported yet "
                                  "(ROADMAP.md §A8)")
    if d.augment:
        raise NotImplementedError("data.augment (on-device augmentation) is "
                                  "not ported yet (ROADMAP.md §A9)")
    if t.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {t.accum_steps}")


def init_state(cfg: CPCConfig, device=None) -> CPCModel:
    """The model, its weights drawn from `train.seed` (on the CPU, so a seed
    gives the same weights on any device), on `device`."""
    return CPCModel(cfg.model, device=device,
                    generator=torch.Generator().manual_seed(cfg.train.seed))


def dropout_generator(seed: int, count: int, microbatch: int,
                      device) -> torch.Generator:
    """The dropout draws of microbatch `microbatch` of optimizer step
    `count`: a function of (train.seed, count, microbatch) alone."""
    mixed = (seed * 0x9E3779B97F4A7C15 + count * 1_000_003 + microbatch)
    return torch.Generator(device=device).manual_seed(mixed % (1 << 63))


def make_step_fns(cfg: CPCConfig, model: CPCModel) -> StepFns:
    check_supported(cfg)
    opt = make_optimizer(cfg, model)
    loss_cfg = cfg.model.loss
    normalize = cfg.data.normalize
    fuse_heads = resolve_fuse_heads(cfg)
    accum = cfg.train.accum_steps
    params = dict(model.named_parameters())
    dropout = cfg.model.ar.kind == "transformer" and cfg.model.ar.dropout > 0

    def loss_fn(model: CPCModel, batch: torch.Tensor, generator=None):
        """(loss, metrics). With a `generator` (and ar.dropout > 0) the
        transformer's dropout is live and draws from it."""
        x = device_prepare(batch, normalize=normalize)
        train = dropout and generator is not None
        if fuse_heads:
            z, c_tm = model.latents_tm(x, train, generator)
            W = model.prediction_heads.weight.t()  # (d_ar, K*d_enc)
            kdtype = torch.bfloat16 if loss_cfg.pallas_bf16 else torch.float32
            return fused_heads_infonce(
                c_tm, z, W, num_steps=loss_cfg.prediction_steps,
                compute_dtype=kdtype, c_time_major=True)
        out = model(x, train, generator)
        return infonce_loss_and_metrics(
            out.preds, out.z, negatives=loss_cfg.negatives,
            use_pallas=loss_cfg.use_pallas,
            pallas_bf16=loss_cfg.pallas_bf16)

    def train_step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One optimizer step. With accum_steps > 1 the batch splits into
        microbatches, each its own negative pool; grads and metrics are
        averaged. Metrics stay on the device (reading them syncs)."""
        B = batch.shape[0]
        if B % accum:
            raise ValueError(
                f"batch {B} is not divisible by accum_steps {accum}")
        for p in params.values():
            p.grad = None
        per_mb = []
        mbs = batch.reshape(accum, B // accum, *batch.shape[1:])
        for i, mb in enumerate(mbs):
            gen = dropout_generator(cfg.train.seed, opt.count, i,
                                    batch.device) if dropout else None
            loss, metrics = loss_fn(model, mb, gen)
            loss.backward()
            per_mb.append({k: v.detach() for k, v in metrics.items()})
        grads = {k: p.grad for k, p in params.items()}
        if accum > 1:
            grads = {k: g / accum for k, g in grads.items()}
        metrics = {k: torch.stack([m[k] for m in per_mb]).mean(0)
                   for k in per_mb[0]}
        metrics["grad_norm"] = global_norm(grads.values())
        opt.step(grads)
        return metrics

    @torch.no_grad()
    def eval_step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        return loss_fn(model, batch)[1]

    return StepFns(train_step=train_step, eval_step=eval_step, optimizer=opt,
                   loss_fn=loss_fn)
