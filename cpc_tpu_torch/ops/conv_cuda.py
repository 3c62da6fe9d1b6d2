"""The conv encoder's pyramid of strided Conv1d + ReLU layers: hand-written
CUDA kernels for the forward, and its plain versions.

Port of `cpc_tpu/ops/conv_pallas.py`: `fused_conv_encoder` with its custom
VJP (`_fwd_rule` / `_bwd_rule`). The TPU kernel replaced is `_make_kernel`
(launched by `_pallas_forward`); the CUDA kernels are
`csrc/conv_pyramid.cu`, whose source note gives the design and what bounds
it on an H100.

    x (B, S)                        compute dtype: float32 or bfloat16
    weights[i] (C_out, C_in, k_i)   torch's conv layout, the same dtype
    biases[i] (C_out,)              the same dtype
    z (B, T_L, C_L)                 the same dtype, contiguous

Layer i is a Conv1d of kernel k_i and stride s_i with flax's SAME padding
(`same_padding`), then bias and ReLU. The rounding points are the TPU
kernel's: products of operands in the compute dtype, fp32 sums, the bias
added in fp32, ReLU, one rounding to the compute dtype a layer. The weights
keep the encoder module's (out, in, k) layout (the JAX function takes flax's
(k, in, out)), so a `state_dict` serves both routes; `pack_weights` repacks
them to (out, k, in) each call, one copy a layer at most and none for a
weight that is already such a view (the encoder casts its parameters
straight into that layout), which is part of the forward's time.

Three plain versions stand beside the kernels:
`conv_pyramid_reference` repeats the kernels' arithmetic tap by tap (what
the CPU runs, and what the kernels are held against on the card);
`conv_chain` is the encoder's `F.conv1d` chain, the same function through
the library's convolution, which the backward recomputes through, as the
TPU route's `_bwd_rule` takes the vjp of XLA's conv chain: no backward
kernel exists on either side.

Neither the TPU kernel's tiling (`plan`, `tz`) nor its envelopes (stride
divides kernel, final length divides the tile) have a counterpart: the CUDA
kernels mask ragged lengths by bounds.

Dispatch is by the device of `x`: a CPU tensor goes through
`_ConvPyramidPlain`, a CUDA tensor through `_ConvPyramidCuda`, whose forward
is the kernels, which run or raise. On the card `pyramid_route` names the
kernels ("wgmma" for bf16 with channels in multiples of 8, "simt" for fp32
and the rest) and plans each launch (grid, tile, ring stages, shared
memory, and the tap table the TMA maps are read with); the plan is passed
to the C launchers, which raise through `check_launch` on a plan they
cannot run: neither route gives way to the other.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from cpc_tpu_torch.ops._build import check_launch, load_library
from cpc_tpu_torch.ops.infonce import WIRE_DTYPES
from cpc_tpu_torch.utils.precision import cudnn_deterministic


def same_padding(t_in: int, k: int, s: int) -> Tuple[int, int]:
    """(left, right) zeros of flax's SAME padding for one strided conv."""
    t_out = -(-t_in // s)
    total = max((t_out - 1) * s + k - t_in, 0)
    return total // 2, total - total // 2


def conv1d(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int) -> torch.Tensor:
    """F.conv1d, except for reduced precision on the CPU: there oneDNN's
    bf16 conv1d (torch 2.13) returns wrong values for some lengths (an
    input length divisible by the stride, measured off by up to 5 at
    outputs of magnitude 5), so the CPU runs the product in fp32 and rounds
    it once, which is what a bf16 conv with fp32 accumulation computes, in
    the backward too. A graph being exported (`export.py`) takes the same
    route on any device, since the artifact runs on the CPU as well. An
    fp32 one-channel conv on the card that a gradient will flow through
    (the encoder's first layer in training) takes `_Repeatable`."""
    if (h.device.type == "cpu" or torch.compiler.is_exporting()) \
            and h.dtype != torch.float32:
        return F.conv1d(h.float(), w.float(), b.float(),
                        stride=stride).to(h.dtype)
    if w.shape[1] == 1 and _repeatable(h, w):
        return _Repeatable.apply(h, w, b, stride)
    return F.conv1d(h, w, b, stride=stride)


def conv2d(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride) -> torch.Tensor:
    """F.conv2d, except that an fp32 conv on the card that a gradient will
    flow through (the scalogram encoder's in training) takes
    `_Repeatable`."""
    if _repeatable(h, w):
        return _Repeatable.apply(h, w, b, stride)
    return F.conv2d(h, w, b, stride=stride)


def _repeatable(h: torch.Tensor, w: torch.Tensor) -> bool:
    return (h.is_cuda and h.dtype == torch.float32 and w.requires_grad
            and torch.is_grad_enabled()
            and not torch.compiler.is_exporting())


class _Repeatable(torch.autograd.Function):
    """F.conv1d or F.conv2d whose backward runs cuDNN's deterministic
    algorithms (`utils.precision.cudnn_deterministic`). In fp32 cuDNN's
    default backward algorithms for the conv1d encoder's first layer (one
    input channel) and for the scalogram encoder's Conv2d layers sum with
    atomics and give other bits each run (2.3e-10 apart on an H100 80GB
    HBM3), so an fp32 run resumed from a checkpoint, or run twice, would
    not be the same run (ROADMAP C16). The forward, and every other op,
    keeps the caller's algorithms."""

    @staticmethod
    def forward(ctx, h, w, b, stride):
        ctx.save_for_backward(h, w)
        ctx.stride = stride
        conv = F.conv1d if h.dim() == 3 else F.conv2d
        return conv(h, w, b, stride=stride)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        grad = torch.nn.grad
        grad_input, grad_weight = ((grad.conv1d_input, grad.conv1d_weight)
                                   if h.dim() == 3 else
                                   (grad.conv2d_input, grad.conv2d_weight))
        with cudnn_deterministic():
            dh = grad_input(h.shape, w, g, stride=ctx.stride) \
                if ctx.needs_input_grad[0] else None
            dw = grad_weight(h, w.shape, g, stride=ctx.stride)
        return dh, dw, g.sum([0, *range(2, g.dim())]), None


def conv_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor], kernels: Sequence[int],
               strides: Sequence[int]) -> torch.Tensor:
    """x (B, S) -> z (B, T_L, C_L) through `F.conv1d` layer by layer with
    SAME padding and ReLU: the encoder's default route for this function. z
    is a transposed view of the convs' (B, C, T)."""
    h = x[:, None, :]
    for w, b, k, s in zip(weights, biases, kernels, strides):
        h = F.relu(conv1d(F.pad(h, same_padding(h.shape[-1], k, s)), w, b, s))
    return h.transpose(1, 2)


def conv_pyramid_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                           biases: Sequence[torch.Tensor],
                           kernels: Sequence[int],
                           strides: Sequence[int]) -> torch.Tensor:
    """Plain version of the forward kernels, with their rounding points: a
    layer is k products in fp32, one a tap, of the strided input rows with
    that tap's (C_in, C_out) weights, summed in fp32; the bias joins in
    fp32; ReLU; one rounding to x's dtype."""
    h = x[:, :, None]  # (B, T, C_in)
    for w, b, k, s in zip(weights, biases, kernels, strides):
        t_in = h.shape[1]
        t_out = -(-t_in // s)
        left, right = same_padding(t_in, k, s)
        hp = F.pad(h.float(), (0, 0, left, right))
        acc = torch.zeros((h.shape[0], t_out, w.shape[0]),
                          dtype=torch.float32, device=x.device)
        for j in range(k):
            rows = hp[:, j:j + s * (t_out - 1) + 1:s]
            acc += rows @ w[:, :, j].float().T
        h = F.relu(acc + b.float()).to(x.dtype)
    return h


def _check(x, weights, biases, kernels, strides) -> None:
    L = len(kernels)
    if not (L >= 1 and len(strides) == len(weights) == len(biases) == L):
        raise ValueError(f"{len(weights)} weights, {len(biases)} biases, "
                         f"{L} kernels, {len(strides)} strides")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (B, S), got {tuple(x.shape)}")
    if x.dtype not in WIRE_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    c_in = 1
    for i, (w, b, k, s) in enumerate(zip(weights, biases, kernels, strides)):
        if k < 1 or s < 1:
            raise ValueError(f"layer {i}: kernel {k}, stride {s}")
        if w.dim() != 3 or w.shape[1:] != (c_in, k):
            raise ValueError(f"weights[{i}] must be (C_out, {c_in}, {k}), "
                             f"got {tuple(w.shape)}")
        if b.shape != (w.shape[0],):
            raise ValueError(f"biases[{i}] must be ({w.shape[0]},), got "
                             f"{tuple(b.shape)}")
        for name, t in ((f"weights[{i}]", w), (f"biases[{i}]", b)):
            if t.dtype != x.dtype or t.device != x.device:
                raise ValueError(f"{name} must be {x.dtype} on {x.device}, "
                                 f"got {t.dtype} on {t.device}")
        c_in = w.shape[0]


# What the C launchers of csrc/conv_pyramid.cu compute, mirrored so that the
# plan is made here (and read by the CPU tests) and checked there.
WGMMA_TILE = (128, 128)  # (output rows, output channels) a block
SIMT_TILE = (64, 64)
ROW_BYTES = 128          # a slab's row: 64 input channels of bf16
WGMMA_STAGES = (2, 6)    # the ring's fewest and most slots
MAX_PHASES = 8           # strides of layers 3..L on "wgmma"
MAX_TAPS = 32            # kernel widths of layers 2..L on "wgmma"
MAX_LAYER1_TAPS = 16     # layer 1's kernel: one k16 step
MAX_SMEM = 227 * 1024
SIMT_STATIC_SMEM = 2 * 16 * 65 * 4  # cpc::TileSmem
EMPTY_ROW = -(1 << 30)   # a phase with no rows: every box row out of range
_ROUTE_CODES = {"simt": 0, "wgmma": 1}


class PyramidLaunch(NamedTuple):
    """One kernel launch of the forward and its plan."""
    layers: Tuple[int, ...]  # (0, 1) fused, (i,) one layer, 0-based
    grid: Tuple[int, int, int]  # (channel tiles, row tiles, B)
    tile: Tuple[int, int]       # (output rows, output channels) a block
    stages: int                 # slots of the TMA ring (0 on "simt")
    smem: int                   # dynamic shared memory, bytes
    # tap j's (phase, row offset): on layers 3..L input row s t + j - pad
    # is row t + offset of phase (j - pad) mod s, offset floor((j - pad) /
    # s), EMPTY_ROW where the phase has no rows; fused, layer 2's tap j
    # reads the slab's slots phase RP + offset.., (j mod s, j // s). Empty
    # on "simt".
    taps: Tuple[Tuple[int, int], ...]


class PyramidRoute(NamedTuple):
    """The kernels the card runs for a pyramid, and their launches."""
    route: str  # "wgmma" or "simt"
    launches: Tuple[PyramidLaunch, ...]


class _Layer(NamedTuple):
    t_in: int
    c_in: int
    k: int
    s: int
    pad: int
    t_out: int
    c_out: int


def _geometry(kernels, strides, channels, S) -> List[_Layer]:
    layers, t, c_in = [], S, 1
    for k, s, c in zip(kernels, strides, channels):
        t_out = -(-t // s)
        layers.append(_Layer(t, c_in, k, s, same_padding(t, k, s)[0], t_out,
                             c))
        t, c_in = t_out, c
    return layers


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _wgmma_launch(layers, ls: Sequence[_Layer], B: int):
    """The "wgmma" plan of one launch, or None if its kernel cannot take
    it."""
    fused = len(layers) == 2
    g = ls[-1]
    if not (g.k <= MAX_TAPS and (g.s <= MAX_PHASES or fused)
            and (not fused or ls[0].k <= MAX_LAYER1_TAPS)):
        return None
    tm, tn = WGMMA_TILE
    slot = (tn if fused else tm + tn) * ROW_BYTES
    fixed = 1024
    if fused:
        rows_a = g.s * (tm + (g.k - 1) // g.s)
        window = (rows_a - 1) * ls[0].s + ls[0].k
        # the slab buffers, a 16-byte row for the generator's rows past a
        # slab, then the waveform window and layer 1's weights and bias,
        # each rounded up to 16 bytes
        fixed += 2 * rows_a * ROW_BYTES + 16 + sum(
            _cdiv(n * 2, 16) * 16
            for n in (window, ls[0].c_out * ls[0].k, ls[0].c_out))
        taps = tuple((j % g.s, j // g.s) for j in range(g.k))
    else:
        taps = []
        for j in range(g.k):
            phase = (j - g.pad) % g.s
            taps.append((phase, (j - g.pad) // g.s if phase < g.t_in
                         else EMPTY_ROW))
        taps = tuple(taps)
    stages = min(WGMMA_STAGES[1], (MAX_SMEM - fixed) // slot)
    grid = (_cdiv(g.c_out, tn), _cdiv(g.t_out, tm), B)
    if stages < WGMMA_STAGES[0] or grid[1] > 65535 or B > 65535:
        return None
    return PyramidLaunch(tuple(layers), grid, WGMMA_TILE, stages,
                         fixed + stages * slot, taps)


def _simt_launch(layers, ls: Sequence[_Layer], B: int) -> PyramidLaunch:
    g = ls[-1]
    smem = 0
    if len(layers) == 2:
        smem = (((SIMT_TILE[0] - 1) * g.s + g.k - 1) * ls[0].s
                + ls[0].k) * 4
    if smem + SIMT_STATIC_SMEM > MAX_SMEM or B > 65535 or _cdiv(
            g.t_out, SIMT_TILE[0]) > 65535:
        raise ValueError(f"no conv pyramid kernel takes layers {layers} "
                         f"(kernel {g.k}, stride {g.s}, batch {B}): "
                         f"{smem} bytes of waveform window")
    return PyramidLaunch(tuple(layers),
                         (_cdiv(g.c_out, SIMT_TILE[1]),
                          _cdiv(g.t_out, SIMT_TILE[0]), B),
                         SIMT_TILE, 0, smem, ())


def pyramid_route(kernels: Sequence[int], strides: Sequence[int],
                  channels: Sequence[int], B: int, S: int,
                  dtype: torch.dtype, aligned: bool = True) -> PyramidRoute:
    """Names the kernels `conv_pyramid_forward` launches on the card for x
    (B, S) in `dtype` through layers of these kernels, strides and output
    channels, and plans each launch: layers 1 and 2 in one, then one a
    layer (a one-layer pyramid: one). Pure Python.

    "wgmma": bf16 with every layer's output channels a multiple of 8 (so
    every input of layers 2..L too), 16-byte aligned weights (`aligned`),
    at least two layers, layer 1's kernel at most 16, later kernels at most
    32 and strides of layers 3..L at most 8, each launch's ring of at least
    two slots within 227 KB of shared memory. "simt": everything else,
    fp32 (the parity configuration) above all. Raises on what no kernel
    takes."""
    if dtype not in WIRE_DTYPES:
        raise TypeError(f"x must be one of {WIRE_DTYPES}, got {dtype}")
    L = len(kernels)
    if not (L >= 1 and len(strides) == len(channels) == L):
        raise ValueError(f"{L} kernels, {len(strides)} strides, "
                         f"{len(channels)} channels")
    if min(B, S, *kernels, *strides, *channels) < 1:
        raise ValueError(f"empty shape: B {B}, S {S}, kernels {kernels}, "
                         f"strides {strides}, channels {channels}")
    ls = _geometry(kernels, strides, channels, S)
    groups = [(0,)] if L == 1 else [(0, 1)] + [(i,) for i in range(2, L)]
    if (dtype == torch.bfloat16 and aligned and L >= 2
            and all(c % 8 == 0 for c in channels)):
        plans = [_wgmma_launch(g, [ls[i] for i in g], B) for g in groups]
        if all(plans):
            return PyramidRoute("wgmma", tuple(plans))
    return PyramidRoute("simt", tuple(
        _simt_launch(g, [ls[i] for i in g], B) for g in groups))


def _plan_array(route: str, launch: PyramidLaunch):
    """The plan as the C launcher reads it: route, grid, tile, stages,
    shared memory, taps n, then (phase, row offset) a tap."""
    flat = [_ROUTE_CODES[route], *launch.grid, *launch.tile, launch.stages,
            launch.smem, len(launch.taps)]
    for tap in launch.taps:
        flat.extend(tap)
    return (ctypes.c_int * len(flat))(*flat), len(flat)


def pack_weights(weights: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The weights (C_out, C_in, k) as the kernels read them, (C_out, k,
    C_in) contiguous: a layer's copy, or none where the weight is already
    a (C_out, C_in, k) view of such a tensor."""
    return [w.permute(0, 2, 1).contiguous() for w in weights]


def pyramid_launches(x, packed, biases, kernels, strides
                     ) -> Tuple[PyramidRoute,
                                List[Callable[[torch.Tensor], torch.Tensor]]]:
    """The route of a forward and one function a launch: fn(h) launches the
    kernel on its input h (x for the first, else the previous launch's
    output) and returns its output (B, T, C). `packed` as `pack_weights`
    returns it."""
    lib = load_library()
    B, S = x.shape
    dev = (int(x.dtype == torch.bfloat16),)
    tail = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    channels = [w.shape[0] for w in packed]
    biases = [b.contiguous() for b in biases]
    ls = _geometry(kernels, strides, channels, S)
    aligned = all(w.data_ptr() % 16 == 0 for w in packed)
    route = pyramid_route(kernels, strides, channels, B, S, x.dtype, aligned)

    def one(launch: PyramidLaunch):
        plan, n = _plan_array(route.route, launch)
        g = ls[launch.layers[-1]]
        what = (f"conv_pyramid_forward ({route.route}, layers "
                f"{'+'.join(str(i + 1) for i in launch.layers)})")

        def fn(h):
            out = torch.empty((B, g.t_out, g.c_out), dtype=x.dtype,
                              device=x.device)
            if len(launch.layers) == 2:
                g1 = ls[0]
                err = lib.conv_pyramid_fused(
                    h.data_ptr(), packed[0].data_ptr(), biases[0].data_ptr(),
                    packed[1].data_ptr(), biases[1].data_ptr(),
                    out.data_ptr(), B, S, g1.k, g1.s, g1.pad, g1.t_out,
                    g1.c_out, g.k, g.s, g.pad, g.t_out, g.c_out, *dev, plan,
                    n, *tail)
            else:
                i = launch.layers[0]
                err = lib.conv_pyramid_layer(
                    h.data_ptr(), packed[i].data_ptr(), biases[i].data_ptr(),
                    out.data_ptr(), B, g.t_in, g.c_in, g.t_out, g.c_out, g.k,
                    g.s, g.pad, *dev, plan, n, *tail)
            check_launch(lib, err, what)
            return out
        return fn

    return route, [one(launch) for launch in route.launches]


def _launch(x, weights, biases, kernels, strides):
    _, launches = pyramid_launches(x, pack_weights(weights), biases, kernels,
                                   strides)
    h = x
    for fn in launches:
        h = fn(h)
    conv_pyramid_forward.launches += 1
    return h


def conv_pyramid_forward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor],
                         kernels: Sequence[int],
                         strides: Sequence[int]) -> torch.Tensor:
    """z (B, T_L, C_L). A CPU tensor runs `conv_pyramid_reference`; a CUDA
    tensor runs the kernels `pyramid_route` names (layers 1 and 2 in one
    launch, then one launch a layer), and `conv_pyramid_forward.launches`
    counts the forwards."""
    args = (x, list(weights), list(biases), tuple(kernels), tuple(strides))
    _check(*args)
    if x.device.type == "cpu":
        return conv_pyramid_reference(*args)
    if x.device.type != "cuda":
        raise ValueError(f"the conv pyramid runs on cpu or cuda, not "
                         f"{x.device}")
    return _launch(*args)


conv_pyramid_forward.launches = 0


def _pyramid_function(name: str, forward_fn):
    """The autograd Function of `forward_fn`: its backward recomputes
    through `conv_chain` and backpropagates through that."""

    class _ConvPyramid(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, kernels, strides, *params):
            L = len(kernels)
            ctx.kernels, ctx.strides = kernels, strides
            ctx.save_for_backward(x, *params)
            return forward_fn(x, params[:L], params[L:], kernels, strides)

        @staticmethod
        def backward(ctx, g):
            L = len(ctx.kernels)
            with torch.enable_grad():
                # standard strides: the encoder's weights arrive as (C_out,
                # C_in, k) views of their packed copies, whose strides (layer
                # 1's (10, 1, 1) too, though .contiguous() keeps it) send
                # cuDNN to channels-last kernels and the chain's elementwise
                # ops to strided ones (PERF.md §5, §6)
                leaves = [t.detach().clone(
                    memory_format=torch.contiguous_format).requires_grad_()
                    for t in ctx.saved_tensors]
                z = conv_chain(leaves[0], leaves[1:L + 1], leaves[L + 1:],
                               ctx.kernels, ctx.strides)
            wanted = [i for i, need in enumerate(
                (ctx.needs_input_grad[0], *ctx.needs_input_grad[3:])) if need]
            grads = dict(zip(wanted, torch.autograd.grad(
                z, [leaves[i] for i in wanted], g)))
            return (grads.get(0), None, None,
                    *(grads.get(i) for i in range(1, 2 * L + 1)))

    _ConvPyramid.__name__ = _ConvPyramid.__qualname__ = name
    return _ConvPyramid


_ConvPyramidPlain = _pyramid_function("_ConvPyramidPlain",
                                      conv_pyramid_reference)
_ConvPyramidCuda = _pyramid_function("_ConvPyramidCuda", conv_pyramid_forward)


def fused_conv_encoder(x: torch.Tensor, weights: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor], kernels: Sequence[int],
                       strides: Sequence[int]) -> torch.Tensor:
    """x (B, S) -> z (B, T_L, C_L), differentiable in x, the weights
    (C_out, C_in, k) and the biases. SAME padding and ReLU a layer, as
    `ConvEncoder` on its default route."""
    fn = _ConvPyramidPlain if x.device.type == "cpu" else _ConvPyramidCuda
    return fn.apply(x.contiguous(), tuple(kernels), tuple(strides), *weights,
                    *biases)
