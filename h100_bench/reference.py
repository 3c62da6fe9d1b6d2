"""The plain reference of a CPC training step, in float32.

What the benchmark holds the trainer's first steps against. It follows the
published model (van den Oord et al., arXiv:1807.03748, section 3.1) in
plain PyTorch and imports nothing of the program: per-snippet normalised
waveform, a strided Conv1d encoder with SAME padding and ReLU, a GRU
(gates r, z, n as torch.nn.GRU) or a pre-LayerNorm causal transformer,
K linear prediction heads, same-step InfoNCE whose candidates are the pool's
latents at the target step, and Adam with an optional global-norm clip and
linear warm-up. Float32 throughout, with TF32 off.

Each part of the model is a module of its own under `model/`, found by
the configuration's kind (`parts`): a model kind that a later cell brings
adds its file. Parameters are a dict of float32 tensors named as the
program's checkpoint names them (`param_specs`), so that the benchmark
can make one set of weights and hand it to both sides.

`precision="fp8"` is the control, FP8 training's usual recipe: every
operand of every convolution and matrix product is rounded to float8 e4m3,
and every gradient that flows back into one to float8 e5m2, each with a
per-tensor scale; sums stay float32. A sound program that computes in
bfloat16 lies closer to the float32 reference than this.
"""

from __future__ import annotations

import contextlib
import importlib.util
import math
from pathlib import Path
from typing import Dict, List, Sequence

import torch

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}
NORM_EPS = 1e-8
ADAM_EPS = 1e-8


PARTS = Path(__file__).resolve().parent / "model"


def parts(model: dict) -> List[object]:
    """The reference's modules of `model`'s encoder, gar and loss:
    `model/encoder_<kind>.py`, `model/gar_<kind>.py` and
    `model/loss_<negatives>.py`, each with specs(model) and forward(...).
    A model the reference does not compute has no file, and raises."""
    names = (f"encoder_{model['encoder']['kind']}",
             f"gar_{model['ar']['kind']}",
             f"loss_{model['loss']['negatives']}")
    out = []
    for name in names:
        path = PARTS / f"{name}.py"
        if not path.exists():
            raise ValueError(f"the reference has no {path.name}")
        spec = importlib.util.spec_from_file_location(
            f"h100_bench_model_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append(mod)
    return out


def param_specs(model: dict) -> List[tuple]:
    """(name, shape, init) of every parameter of `model` (a config's
    "model" section), named as the program's checkpoint names them. init
    is ("normal", std), ("zeros",) or ("ones",)."""
    return [s for part in parts(model) for s in part.specs(model)]


# ------------------------------------------------------------ precision
def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` under the scale that maps its largest magnitude
    to the format's largest."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX[dtype], torch.ones_like(amax))
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    """Rounds the value to e4m3 on the way in and its gradient to e5m2 on
    the way back."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def rounding(precision: str):
    """The operand rounding of `precision`: 'fp32' (none) or 'fp8'."""
    if precision == "fp32":
        return lambda x: x
    if precision == "fp8":
        return _RoundFp8.apply
    raise ValueError(f"unknown precision {precision!r}")


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions, restored after."""
    kept = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = kept


# ------------------------------------------------------------ the model
def prepare(batch: torch.Tensor) -> torch.Tensor:
    """int16 (B, S) -> float32, each snippet to zero mean and unit
    (population) variance."""
    x = batch.to(torch.float32) / 32768.0
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + NORM_EPS)


def loss_fn(w: Dict[str, torch.Tensor], batch: torch.Tensor, model: dict,
            rnd, modules):
    """(loss, acc_mean) of an int16 batch: prepare, encoder, gar, loss."""
    encoder, gar, loss = modules
    z = encoder.forward(w, prepare(batch), model, rnd)
    return loss.forward(w, gar.forward(w, z, model, rnd), z, model, rnd)


# ------------------------------------------------------------ Adam
def learning_rate(train: dict, count: int) -> float:
    """The learning rate of update `count` (0, 1, ...): linear warm-up from
    0 over warmup_steps, then constant, or a cosine decay to 0 at
    num_steps."""
    lr, wu = train["learning_rate"], train["warmup_steps"]
    if count < wu:
        return lr * count / wu
    if train["lr_schedule"] == "constant":
        return lr
    if train["lr_schedule"] != "cosine":
        raise ValueError(f"unknown lr_schedule {train['lr_schedule']!r}")
    decay = max(train["num_steps"], wu + 1) - wu
    m = min(count - wu, decay)
    return lr * 0.5 * (1.0 + math.cos(math.pi * m / decay))


def train_steps(weights: Dict[str, torch.Tensor],
                batches: Sequence[torch.Tensor], cfg: dict,
                precision: str = "fp32") -> dict:
    """Adam steps from `weights` (left unchanged), one a batch (each the
    whole global batch, int16 (B, S), on the weights' device). Returns the
    readings the benchmark compares: each step's loss and accuracy, each
    leaf's norm of the first gradient as Adam takes it (after the clip),
    and each leaf's norm of its change after the last step."""
    model, train = cfg["model"], cfg["train"]
    rnd = rounding(precision)
    modules = parts(model)
    b1, b2 = train["beta1"], train["beta2"]
    clip, wd = train["grad_clip_norm"], train["weight_decay"]
    w = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    out = {"loss": [], "acc": []}
    with exact_float32():
        for count, batch in enumerate(batches):
            loss, acc = loss_fn(w, batch, model, rnd, modules)
            grads = torch.autograd.grad(loss, list(w.values()),
                                        allow_unused=True)
            g = {k: (gr if gr is not None else torch.zeros_like(w[k]))
                 for k, gr in zip(w, grads)}
            out["loss"].append(float(loss.detach()))
            out["acc"].append(float(acc))
            with torch.no_grad():
                if clip > 0:
                    norm = torch.sqrt(sum((v ** 2).sum() for v in g.values()))
                    if norm >= clip:
                        g = {k: v * (clip / norm) for k, v in g.items()}
                if count == 0:
                    out["grad_norm"] = {k: float(v.norm())
                                        for k, v in g.items()}
                lr = learning_rate(train, count)
                bc1, bc2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
                for k, p in w.items():
                    mu[k].mul_(b1).add_((1.0 - b1) * g[k])
                    nu[k].mul_(b2).add_((1.0 - b2) * g[k] ** 2)
                    u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
                    if wd > 0:
                        u = u + wd * p
                    p.sub_(lr * u)
    with torch.no_grad():
        out["change_norm"] = {k: float((w[k] - weights[k]).norm())
                              for k in w}
    return out
