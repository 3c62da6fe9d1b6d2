"""Tensor parallelism: parameters sharded over the 'model' axis of a
(data, model) mesh, the batch split over 'data'.

Port of `cpc_tpu/parallel/tp.py`. The JAX module annotates the parameters
and lets GSPMD insert the collectives; the port runs one process (or
thread rank, `parallel.mesh.thread_meshes(..., model=m)`) a device, each
holding its shard of every rule-matched parameter (`shard_params`), and
writes each collective out as an autograd function:

  * weight-gathered, the conv1d and conv2d kernels and biases of either
    encoder and the prediction heads (`_Whole`): each rank holds the
    shard of the output channels, gathers the shards over 'model' in the
    forward and computes the whole product, as one device computes it; the
    backward keeps this rank's slice of the weight's gradient. The
    activations stay whole on every model rank, so nothing of their size
    crosses the axis (a weight is a few MB, an activation at tpu_fast's
    width hundreds), and the norm and activation after read every
    channel. These layers' parameters and Adam moments are split over
    'model', their arithmetic is not;
  * column parallel inside a transformer block (`_LinearLocal`: the
    query / key / value projections, over heads, so attention is
    head-local, and the MLP's first layer): the output stays local and
    each rank's input gradient is a partial product, summed over 'model'
    in fp32 and rounded once;
  * row parallel on the contraction: the GRU's input projection `wi`, the
    attention's `out` and the MLP's second layer. Each rank multiplies its
    slice of the input (`_Scatter`, whose backward gathers the gradient)
    by its rows, and `_Reduce` sums the partial products over 'model' in
    fp32 (rounded once to the compute dtype after the bias is added; the
    GRU adds `bi` after the rounding, as its own projection does); the
    sum's backward passes the gradient through;
  * everything else (norms, the GRU's recurrent weights, `in_proj`, the
    LayerNorms, the scalogram's `proj`) is replicated, and every
    replicated activation carries its whole gradient on every model rank:
    a replicated parameter's gradient is the same on each, never summed
    over 'model'.

Every sum over 'model' is in fp32 and rounded once (a bf16 partial
rounded before the sum moves a step's gradients by a rounding of their
own), and every gather is exact.

The norms give the global array's statistics, as GSPMD's do: a 'batch'
norm's statistics span the data axis (`_Norm`'s ring), 'layer' and
'group' run on the whole channels. The GRU recurrence runs on every
rank through the config's route (the CUDA kernels on the card), and
attention through the model's `attn_impl`, head-local ('ring' and
'zigzag' raise). The loss is the plain InfoNCE over the GLOBAL batch
(z gathered over 'data', whatever loss.cross_replica, use_pallas,
fuse_heads or ring say), as JAX's TP step computes it; gradients and
metrics are averaged over 'data' alone, and grad_norm and the clip see
the global norm: the sharded gradients' squares summed over 'model',
each replicated one counted once (`global_norm`). The step has no
microbatching, augmentation or dropout (JAX's runs `train=False`), and
`encoder.use_pallas` (one kernel for the whole pyramid) raises. An fp32
model steps with TF32 off.

Every collective is an all_reduce sum (`ops.ring_util`): a gather is a
zeroed buffer summed, a reduce-scatter a sum followed by a slice, as in
`parallel/dp.py`, so the same code runs under NCCL, under gloo ranks that
share a card, and under thread ranks.

Init is the single-device model from the seed on every rank, then
`shard_params`, as JAX's `init_state` then `shard_fn`; `gather_params`
rebuilds the whole parameters from the shards.
"""

from __future__ import annotations

import functools
import re
import warnings
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cpc_tpu_torch.config import CPCConfig
from cpc_tpu_torch.data.loader import device_prepare
from cpc_tpu_torch.models.cpc import CPCOutput
from cpc_tpu_torch.ops.conv_cuda import conv1d, conv2d
from cpc_tpu_torch.ops.gru_cuda import gru_scan
from cpc_tpu_torch.ops.infonce import infonce_loss_and_metrics
from cpc_tpu_torch.ops.ring_util import Ring
from cpc_tpu_torch.parallel.dp import average
from cpc_tpu_torch.parallel.mesh import ProcessMesh
from cpc_tpu_torch.utils.precision import exact_for

# (suffix pattern on the port's parameter name, rank, the sharded dim,
# whole heads): the JAX package's 12 rules, on the names and layouts that
# `interop.from_jax_params` gives the flax parameters (torch's (out, in,
# *kernel) convs and (out, in) dense weights). A rule-matched parameter
# whose width does not divide the model axis replicates WITH a warning; a
# parameter no rule matches replicates silently, by design. The attention
# projections shard whole heads, so their width is counted in heads, as
# JAX's (d, H, Dh) kernels count it.
_RULES: Tuple[Tuple[str, int, int, bool], ...] = (
    (r"prediction_heads\.weight$", 2, 0, False),
    (r"encoder\.conv\d+\.weight$", 3, 0, False),
    (r"encoder\.conv\d+\.bias$", 1, 0, False),
    (r"encoder\.conv2d_\d+\.weight$", 4, 0, False),
    (r"encoder\.conv2d_\d+\.bias$", 1, 0, False),
    (r"gar\.layer\d+\.wi$", 2, 0, False),
    (r"attn\.(query|key|value)\.weight$", 2, 0, True),
    (r"attn\.(query|key|value)\.bias$", 1, 0, True),
    (r"attn\.out\.weight$", 2, 1, True),
    (r"gar\.block\d+\.fc1\.weight$", 2, 0, False),
    (r"gar\.block\d+\.fc1\.bias$", 1, 0, False),
    (r"gar\.block\d+\.fc2\.weight$", 2, 1, False),
)


def _rule(name: str, shape, model_size: int, num_heads: int
          ) -> Optional[int]:
    """The dim along which parameter `name` of `shape` shards over a
    `model_size`-way axis, or None (replicated)."""
    for pat, ndim, dim, heads in _RULES:
        if len(shape) != ndim or re.search(pat, name) is None:
            continue
        width = num_heads if heads else shape[dim]
        if width % model_size != 0:
            warnings.warn(
                f"TP: {name} dim {dim} ({width}"
                f"{' heads' if heads else ''}) is not divisible by the "
                f"{model_size}-way model axis; replicating this param (pad "
                f"the width or shrink the model axis to shard it)",
                stacklevel=3)
            return None
        return dim
    return None


def _num_heads(model) -> int:
    ar = model.config.ar
    return ar.num_heads if ar.kind == "transformer" else 1


def sharded_param_paths(model, mesh: ProcessMesh) -> Dict[str, Tuple[int,
                                                                     int]]:
    """{parameter name: (dim, model size)} for every parameter of `model`
    that a rule shards on `mesh`: a sharded model's own layout, else the
    one `shard_params` would give it. The audit of a model family's TP
    coverage, as in the JAX package."""
    if getattr(model, "tp_shards", None) is not None:
        return dict(model.tp_shards)
    heads = _num_heads(model)
    out = {}
    for name, p in model.named_parameters():
        dim = _rule(name, p.shape, mesh.model, heads)
        if dim is not None:
            out[name] = (dim, mesh.model)
    return out


@torch.no_grad()
def shard_params(model, mesh: ProcessMesh):
    """Keeps, in place, this rank's slice of every rule-matched parameter
    of `model` (whole parameters, drawn alike on every rank): the
    model_rank-th of `mesh.model` equal chunks along the rule's dim. An
    optimizer made afterwards keeps its moments in the same shards.
    Returns the model, its layout in `model.tp_shards`."""
    if getattr(model, "tp_shards", None) is not None:
        raise ValueError("the model is sharded already")
    shards = sharded_param_paths(model, mesh)
    params = dict(model.named_parameters())
    for name, (dim, m) in shards.items():
        p = params[name]
        w = p.shape[dim] // m
        p.data = p.data.narrow(dim, mesh.model_rank * w, w).clone()
    model.tp_shards = shards
    return model


@torch.no_grad()
def gather_params(model, mesh: ProcessMesh,
                  tensors: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The whole parameters of a sharded `model`, on every rank: each
    shard gathered over 'model' (a collective every rank makes), each
    replicated parameter as it is. `tensors` ({name: tensor} in the
    parameters' layout: their gradients, Adam's moments) are gathered in
    their place."""
    ring = mesh.ring("model")
    if tensors is None:
        tensors = dict(model.named_parameters())
    return {name: (_gather(t.detach(), ring, model.tp_shards[name][0])
                   if name in model.tp_shards else t.detach().clone())
            for name, t in tensors.items()}


# ------------------------------------------------------------ collectives
def _sum32(t: torch.Tensor, ring: Ring) -> torch.Tensor:
    """t summed over the ring in fp32 (a new tensor)."""
    out = t.to(torch.float32, copy=True).contiguous()
    ring.all_reduce(out)
    return out


def _gather(t: torch.Tensor, ring: Ring, dim: int) -> torch.Tensor:
    """Every rank's t concatenated along `dim` in rank order: a zeroed
    buffer with this rank's part, summed (exact: the rest adds zeros)."""
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * ring.size
    full = t.new_zeros(shape)
    full.narrow(dim, ring.index * n, n).copy_(t)
    ring.all_reduce(full)
    return full


def _slice(t: torch.Tensor, ring: Ring, dim: int) -> torch.Tensor:
    n = t.shape[dim] // ring.size
    return t.narrow(dim, ring.index * n, n).contiguous()


def _product(kind: str, stride, x, w, b):
    if kind == "conv1d":
        return conv1d(x, w, b, stride)
    if kind == "conv2d":
        return conv2d(x, w, b, stride)
    return F.linear(x, w, b)


class _Whole(torch.autograd.Function):
    """Every rank's shard of a weight (or bias), gathered along its output
    channels; the backward keeps this rank's slice of the whole gradient,
    which every model rank computes alike from the same replicated
    activations (no sum over 'model')."""

    @staticmethod
    def forward(ctx, w, ring):
        ctx.ring = ring
        return _gather(w, ring, 0)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.ring, 0), None


class _LinearLocal(torch.autograd.Function):
    """F.linear(x, w, b) with this rank's output features, kept local; the
    backward sums the ranks' partial input gradients over 'model' in fp32
    and rounds once."""

    @staticmethod
    def forward(ctx, x, w, b, ring):
        ctx.save_for_backward(x, w)
        ctx.ring = ring
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _sum32((g2.float() @ w.float()).reshape(x.shape),
                        ctx.ring).to(x.dtype)
        dw = (g2.t() @ x.reshape(-1, x.shape[-1])).to(w.dtype)
        return dx, dw, g2.sum(0).to(w.dtype), None


class _Reduce(torch.autograd.Function):
    """g: the sum over 'model' of each rank's partial product, in fp32;
    the backward passes the (replicated) gradient through."""

    @staticmethod
    def forward(ctx, x, ring):
        return _sum32(x, ring)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    """This rank's slice along `dim`; the backward gathers every rank's
    slice of the gradient."""

    @staticmethod
    def forward(ctx, x, ring, dim):
        ctx.ring, ctx.dim = ring, dim
        return _slice(x, ring, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.ring, ctx.dim), None, None


# ------------------------------------------------------------ the forward
class _Layout:
    """What a TP forward needs of the mesh and the model's shards."""

    def __init__(self, model, mesh: ProcessMesh):
        self.shards = model.tp_shards
        self.model = mesh.ring("model")
        data = mesh.ring("data")
        # a batch norm's statistics span the global batch
        self.norm_ring = data if data.size > 1 else None

    def sharded(self, name: str) -> bool:
        return name in self.shards

    def column(self, x: torch.Tensor, w, b, kind: str, stride,
               name: str) -> torch.Tensor:
        """The product of x with parameter `name` (w, and b), its shards
        gathered over 'model' where `name` is sharded: the whole product on
        every rank, one device's bits."""
        if self.sharded(name):
            w = _Whole.apply(w, self.model)
            b = None if b is None else _Whole.apply(b, self.model)
        return _product(kind, stride, x, w, b)

    def local(self, x: torch.Tensor, dense) -> torch.Tensor:
        """dense(x), its output features this rank's shard, kept local."""
        dt = dense.dtype
        return _LinearLocal.apply(x.to(dt), dense.weight.to(dt),
                                  dense.bias.to(dt), self.model)

    def row(self, x: torch.Tensor, dense) -> torch.Tensor:
        """dense(x) with `dense.weight` row-sharded over x's last dim (x
        whole, in this rank's shard's order): the partial products summed
        in fp32, the bias added, rounded once."""
        dt = dense.dtype
        part = F.linear(x.to(dt).float(), dense.weight.to(dt).float())
        return (_Reduce.apply(part, self.model)
                + dense.bias.to(dt).float()).to(dt)


def _conv_block(enc, tp: _Layout, h: torch.Tensor, i: int) -> torch.Tensor:
    """Encoder block i under TP: the block's padding, its conv on the
    gathered weight, then the norm and activation."""
    if enc.config.kind == "conv1d":
        kind, stride, name = "conv1d", enc.config.strides[i], f"conv{i}"
    else:
        kind, stride, name = "conv2d", enc.geometry[i][1:3], f"conv2d_{i}"
    conv = getattr(enc, name)
    h = tp.column(enc._pad(h, i), conv.weight.to(enc.dtype),
                  conv.bias.to(enc.dtype), kind, stride,
                  f"encoder.{name}.weight")
    ring = tp.norm_ring if enc.config.norm == "batch" else None
    return enc._finish(h, i, ring)


def _encode(enc, x: torch.Tensor, tp: _Layout) -> torch.Tensor:
    return enc(x, functools.partial(_conv_block, enc, tp))


def _gru(gar, z: torch.Tensor, tp: _Layout) -> torch.Tensor:
    """The GRU under TP: each layer's input projection row parallel on
    its sharded `wi`, the recurrence on every rank (`gru_scan`)."""
    h = z
    for n, layer in enumerate(gar.layers()):
        if not tp.sharded(f"gar.layer{n}.wi"):
            h = layer(h)
            continue
        B, T, _ = h.shape
        dt = layer.dtype
        x = _Scatter.apply(h.to(dt), tp.model, 2)
        part = x.reshape(B * T, -1).float() @ layer.wi.to(dt).float()
        xproj = _Reduce.apply(part, tp.model).to(dt) + layer.bi.to(dt)
        xproj = xproj.reshape(B, T, -1).transpose(0, 1).contiguous()
        H = layer.wh.shape[0]
        h0 = torch.zeros(B, H, dtype=torch.float32, device=h.device)
        h = gru_scan(xproj, layer.wh.to(dt).contiguous(), layer.bh.to(dt),
                     h0).transpose(0, 1)
    return h


def _block(blk, tp: _Layout, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """A pre-LN transformer block under TP (Megatron's layout): attention
    over this rank's heads closed by `out` row parallel, the MLP with fc1
    column parallel (no gather: fc2 reads the shard) and fc2 row
    parallel."""
    a = blk.attn
    h = blk.ln_attn(x)
    if tp.sharded(prefix + "attn.query.weight"):
        B, T, d = h.shape
        dh = d // a.num_heads
        q, k, v = (tp.local(h, p).view(B, T, -1, dh)
                   for p in (a.query, a.key, a.value))
        o = a.attend(q, k, v, False, None)
        h = tp.row(o.reshape(B, T, -1), a.out)
    else:
        h = a(h)
    x = x + h
    m = blk.ln_mlp(x)
    if tp.sharded(prefix + "fc1.weight"):
        m = F.gelu(tp.local(m, blk.fc1), approximate="tanh")
        m = tp.row(m, blk.fc2)
    else:
        m = blk.fc2(F.gelu(blk.fc1(m), approximate="tanh"))
    return x + m


def _transformer(gar, z: torch.Tensor, tp: _Layout) -> torch.Tensor:
    cfg = gar.config
    T = z.shape[1]
    if T > cfg.max_len:
        raise ValueError(f"sequence length {T} > max_len {cfg.max_len}")
    x = gar.in_proj(z) + gar.pos_embed[:T].to(gar.dtype)[None]
    for i, blk in enumerate(gar.blocks()):
        run = functools.partial(_block, blk, tp, f"gar.block{i}.")
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(run, x, use_reentrant=False)
        else:
            x = run(x)
    return gar.final_norm(x)


def tp_forward(model, x: torch.Tensor, mesh: ProcessMesh) -> CPCOutput:
    """The model's forward on this rank's rows of the prepared waveform,
    its parameters sharded by `shard_params`: z, c and the predictions
    whole on every model rank."""
    tp = _Layout(model, mesh)
    cfg = model.config
    z = _encode(model.encoder, x, tp)
    if cfg.ar.kind == "transformer":
        c = _transformer(model.gar, z, tp)
    else:
        c = _gru(model.gar, z, tp)
    preds = tp.column(c, model.prediction_heads.weight.to(model.dtype),
                      None, "linear", None, "prediction_heads.weight")
    B, T, _ = c.shape
    return CPCOutput(z=z, c=c, preds=preds.reshape(
        B, T, cfg.loss.prediction_steps, cfg.encoder.d_enc))


def global_norm(grads: Mapping[str, torch.Tensor], model,
                mesh: ProcessMesh) -> torch.Tensor:
    """optax's global norm of the whole gradients from this rank's: the
    sharded gradients' squares summed over 'model', each replicated
    gradient counted once, in fp32."""
    sq = [torch.sum(g.float() ** 2) for k, g in grads.items()
          if k in model.tp_shards]
    rep = [torch.sum(g.float() ** 2) for k, g in grads.items()
           if k not in model.tp_shards]
    zero = torch.zeros((), dtype=torch.float32,
                       device=next(iter(grads.values())).device)
    sharded = _sum32(sum(sq, zero).reshape(1), mesh.ring("model"))[0]
    return torch.sqrt(sharded + sum(rep, zero))


# ---------------------------------------------------------------- the step
class TPStepFns(NamedTuple):
    train_step: Callable  # this rank's rows (b, S) -> metrics; in place
    optimizer: Any        # train_step.Optimizer over the shards


def check_tp(cfg: CPCConfig, mesh: ProcessMesh) -> None:
    """What the TP step cannot run raises here, with the reason."""
    if mesh.ctx > 1:
        raise ValueError("tensor parallelism does not combine with a 'ctx' "
                         "axis")
    bad = [k for k, v in (
        ("train.accum_steps > 1", cfg.train.accum_steps > 1),
        ("data.augment", cfg.data.augment),
        ("model.ar.dropout > 0", cfg.model.ar.dropout > 0),
        ("model.encoder.use_pallas", cfg.model.encoder.use_pallas),
        ("model.ar.attn_impl ring|zigzag",
         cfg.model.ar.attn_impl in ("ring", "zigzag"))) if v]
    if bad:
        raise ValueError(
            f"the TP step has no microbatching, augmentation or dropout, "
            f"cannot split the one-kernel conv pyramid, and runs attention "
            f"head-local: {bad} — leave them at their defaults")
    if cfg.data.batch_size % mesh.data:
        raise ValueError(
            f"batch_size {cfg.data.batch_size} is not divisible by the "
            f"{mesh.data}-way data axis")


def make_tp_train_step(cfg: CPCConfig, model, mesh: ProcessMesh
                       ) -> TPStepFns:
    """The training step over a (data, model) mesh: shards `model` in
    place (`shard_params`; its whole weights from the seed on every rank)
    and makes the optimizer over the shards, its moments sharded alike and
    its clip on the global norm. train_step(rows) takes this rank's rows
    of the global int16 batch (`mesh.rows`): device_prepare, the TP
    forward, the plain InfoNCE over the global batch, the backward, the
    gradients and metrics averaged over 'data', then the update."""
    from cpc_tpu_torch.train.train_step import make_optimizer
    check_tp(cfg, mesh)
    shard_params(model, mesh)
    opt = make_optimizer(cfg, model)
    opt.norm = functools.partial(global_norm, model=model, mesh=mesh)
    params = dict(model.named_parameters())
    pool_mesh = mesh.data_mesh()
    negatives, normalize = cfg.model.loss.negatives, cfg.data.normalize

    def loss_fn(model, rows: torch.Tensor):
        out = tp_forward(model, device_prepare(rows, normalize=normalize),
                         mesh)
        return infonce_loss_and_metrics(out.preds, out.z,
                                        negatives=negatives, mesh=pool_mesh)

    def train_step(rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        for p in params.values():
            p.grad = None
        # the backward runs in this thread: thread ranks' collectives
        with torch.autograd.set_multithreading_enabled(False), \
                exact_for(model.dtype):
            loss, metrics = loss_fn(model, rows)
            loss.backward()
        names = list(params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        means = average([params[k].grad for k in names]
                        + list(metrics.values()), pool_mesh)
        grads = dict(zip(names, means[:len(names)]))
        metrics = dict(zip(metrics, means[len(names):]))
        metrics["grad_norm"] = opt.norm(grads)
        opt.step(grads)
        return metrics

    return TPStepFns(train_step=train_step, optimizer=opt)
