"""Causal flash attention for the transformer gar: hand-written CUDA kernels
and their plain versions.

Port of `cpc_tpu/ops/attention_pallas.py`: `flash_causal_mha` and the
custom-VJP `_flash` with `_flash_fwd_rule` / `_flash_bwd_rule`. The TPU
kernels replaced are `_fwd_kernel`, `_dq_kernel` and `_dkv_kernel` (the last
two by one kernel on the 'flash16' path); the CUDA kernels are
`csrc/flash_attention.cu`, whose source note gives their design and what
bounds them on an H100.

    q, k, v (B, T, H, Dh)   float32 or bfloat16, the head layout the
                            projections produce; read through their batch,
                            time and head strides (last axis contiguous), so
                            heads are never folded into a transposed copy
    o (B, T, H, Dh)         q's dtype, contiguous
    lse (B, H, T) fp32      log-sum-exp of each row's scaled, masked scores

Numerics, the TPU kernels': S = Q K^T from the inputs in their own dtype
with fp32 sums, times `scale` in fp32 after the product; positions above the
diagonal masked to -1e30; softmax statistics in fp32; P and V cast to
`p_dtype` for P V with fp32 sums; o rounded once to q's dtype. The backward
recomputes P = exp(S - lse) and uses

    dres = rowsum(dO * O)                  fp32, elementwise tensor code
    dS = P * (dO V^T - dres) * scale
    dQ = dS K      dV = P^T dO      dK = dS^T Q

with P, dS, dO, Q, K, V cast to `p_dtype` as operands of those four
products, fp32 sums, and outputs rounded once to the inputs' dtype. The
(T, T) scores are never stored on the device by the CUDA path; the plain
versions do form them.

Dispatch is by the device of `q`: a CPU tensor goes through `_FlashPlain`
(`flash_attention_forward_reference`, `flash_attention_backward_reference`),
a CUDA tensor through `_FlashCuda`, whose halves are `flash_attention_forward`
and `flash_attention_backward`: kernels, which run or raise. On the card
`attention_route` names the kernels a shape takes. bf16 inputs with bf16 P
('flash16'), Dh in {16, 32, 64}: the tiled forward ("resident": one block a
(batch, head) up to T = 128; "tiled" beyond) and the one-pass backward,
which forms P and dS once for dq, dk and dv ("one_pass_resident": one block
keeps a head's dQ in its shared memory; "one_pass_split": a few blocks a
head, their fp32 partials of dQ added in a fixed order by a second launch).
Everything else takes the fp32-P or the SIMT forward and the pair of kernels
behind `flash_attention_dq` and `flash_attention_dkv`, which stay as direct
wrappers. The tiled forward takes each row's max before scaling, so it
raises on a scale that is not positive. Each kernel's wrapper counts its
launches (`flash_attention_forward.launches`, ...).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from cpc_tpu_torch.ops._build import check_launch, load_library
from cpc_tpu_torch.ops.infonce import WIRE_DTYPES, on_device

NEG = -1e30  # the masked score, as the TPU kernels' _NEG
P_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_HEAD_DIM = 128  # what the kernels hold of one head in registers
MMA_HEAD_DIMS = (16, 32, 64)  # head widths with tensor-core kernels
_TILE, _ROWS = 64, 128  # the kernels' tile of the swept side, of their own
_SMEM_LIMIT = 232448    # bytes of shared memory a block may ask for (sm_90)
_SMS = 132              # SMs of an H100, where no device is at hand to ask
# the one-pass backward keeps a head's dQ in one block's shared memory when
# at least this many (batch, head) pairs share the card (one block each)
_RESIDENT_MIN_HEADS = 64
_MAX_GROUPS = 4   # fp32 partials of dQ, each (B, T, H, Dh), on the split route


class AttentionRoute(NamedTuple):
    """The kernels a shape takes on the card."""
    forward: str   # "resident" | "tiled" | "exact" | "simt"
    backward: str  # "one_pass_resident" | "one_pass_split" | "pair"
    groups: int    # groups of key tiles a head on the split route, else 0


def one_pass_smem(T: int, Dh: int, resident: bool) -> int:
    """Bytes of dynamic shared memory of a one-pass backward block: K, V; a
    ring of two of Q and dO; dS^T twice; lse and dres twice; on the resident
    route the head's dQ in fp32 after them. `attention_route` needs it
    without a card; the library's own count (`launch_shape`, whose launcher
    refuses what does not fit) is held equal to it by the CUDA tests."""
    row_bytes = (Dh + 8) * 2  # a padded bf16 row of a tile
    smem = ((2 * _ROWS + 4 * _TILE) * row_bytes
            + 2 * _ROWS * (_TILE + 8) * 2 + 4 * _TILE * 4)
    return smem + (-(-T // _TILE) * _TILE * Dh * 4 if resident else 0)


def attention_route(B: int, T: int, H: int, Dh: int, dtype: torch.dtype,
                    p_dtype: str, aligned: bool = True,
                    sms: int = _SMS) -> AttentionRoute:
    """Names the kernels `flash_attention_forward` and
    `flash_attention_backward` launch on the card. Pure Python.

    bf16 inputs with bf16 P ('flash16'), Dh in {16, 32, 64} and 16-byte
    aligned rows (`aligned`) take the redesigned kernels. Forward:
    "resident" up to T = 128 (one block a (batch, head), Q, K and V in its
    shared memory from one round of copies, 8 warps of 16 rows), "tiled"
    beyond (64 query rows a block, 4 warps, a ring of K/V tiles). Backward,
    one pass: "one_pass_resident" (one block a (batch, head) keeps dQ of the
    head in shared memory) where that fits and there are heads enough to
    fill the card, or a single key tile; else "one_pass_split" (`groups`
    blocks a head, each with an fp32 partial of dQ, added in group order by
    a finishing kernel; as many groups as fill `sms` SMs, at most
    `_MAX_GROUPS`). Everything else takes the pair of dQ and dK/dV
    kernels and the other forwards: "exact" (bf16 inputs, fp32 P: scores
    on the tensor cores, the other products on the SIMT pipe) or "simt"."""
    if dtype not in WIRE_DTYPES:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {dtype}")
    if min(B, T, H, Dh) < 1:
        raise ValueError(f"empty input {(B, T, H, Dh)}")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernels take Dh <= {MAX_HEAD_DIM}, "
                         f"got {Dh}")
    bf16_p = _p_dtype(p_dtype) == torch.bfloat16
    mma = dtype == torch.bfloat16 and Dh in MMA_HEAD_DIMS and aligned
    if not (mma and bf16_p):
        return AttentionRoute("exact" if mma else "simt", "pair", 0)
    forward = "resident" if T <= _ROWS else "tiled"
    key_tiles = -(-T // _ROWS)
    if one_pass_smem(T, Dh, resident=True) <= _SMEM_LIMIT and (
            key_tiles == 1 or B * H >= _RESIDENT_MIN_HEADS):
        return AttentionRoute(forward, "one_pass_resident", 0)
    groups = min(key_tiles, _MAX_GROUPS, max(2, math.ceil(sms / (B * H))))
    return AttentionRoute(forward, "one_pass_split", groups)


def _p_dtype(p_dtype: str) -> torch.dtype:
    if p_dtype not in P_DTYPES:
        raise ValueError(f"p_dtype must be 'float32' or 'bfloat16', got "
                         f"{p_dtype!r}")
    return P_DTYPES[p_dtype]


def _heads_first(x: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """(B, T, H, Dh) -> (B, H, T, Dh) fp32, after a rounding to `dtype`: a
    product of these is the kernels' "operands in `dtype`, fp32 sums"."""
    if dtype is not None:
        x = x.to(dtype)
    return x.permute(0, 2, 1, 3).float()


def _masked_scores(q, k, scale):
    """(B, H, T, T) fp32: Q K^T * scale, -1e30 above the diagonal."""
    T = q.shape[1]
    s = (_heads_first(q) @ _heads_first(k).transpose(-1, -2)) * scale
    keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    return torch.where(keep, s, torch.full((), NEG, device=q.device))


def flash_attention_forward_reference(q, k, v, scale: float,
                                      p_dtype: str = "float32"):
    """Plain version of the forward kernel: (o (B, T, H, Dh) in q's dtype,
    lse (B, H, T) fp32)."""
    pd = _p_dtype(p_dtype)
    s = _masked_scores(q, k, scale)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(pd).float() @ _heads_first(v, pd)) / l
    return (o.permute(0, 2, 1, 3).to(q.dtype).contiguous(),
            (m + torch.log(l))[..., 0])


def _p_and_ds(q, k, v, do, lse, dres, scale, pd):
    """(P, dS), each (B, H, T, T) fp32, from the saved lse."""
    p = torch.exp(_masked_scores(q, k, scale) - lse[..., None])
    dp = _heads_first(do, pd) @ _heads_first(v, pd).transpose(-1, -2)
    return p, p * (dp - dres[..., None]) * scale


def flash_attention_dq_reference(q, k, v, do, lse, dres, scale: float,
                                 p_dtype: str = "float32"):
    """Plain version of the dQ kernel: dq (B, T, H, Dh) in q's dtype."""
    pd = _p_dtype(p_dtype)
    _, ds = _p_and_ds(q, k, v, do, lse, dres, scale, pd)
    dq = ds.to(pd).float() @ _heads_first(k, pd)
    return dq.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def flash_attention_dkv_reference(q, k, v, do, lse, dres, scale: float,
                                  p_dtype: str = "float32"):
    """Plain version of the dK/dV kernel: (dk, dv), (B, T, H, Dh) in k's and
    v's dtype."""
    pd = _p_dtype(p_dtype)
    p, ds = _p_and_ds(q, k, v, do, lse, dres, scale, pd)
    dv = p.to(pd).float().transpose(-1, -2) @ _heads_first(do, pd)
    dk = ds.to(pd).float().transpose(-1, -2) @ _heads_first(q, pd)
    return (dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


def flash_attention_backward_reference(q, k, v, do, lse, dres, scale: float,
                                       p_dtype: str = "float32"):
    """Plain version of the one-pass backward kernel: (dq, dk, dv), the dQ
    and dK/dV plain versions side by side."""
    dq = flash_attention_dq_reference(q, k, v, do, lse, dres, scale, p_dtype)
    dk, dv = flash_attention_dkv_reference(q, k, v, do, lse, dres, scale,
                                           p_dtype)
    return dq, dk, dv


def row_dot(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """dres (B, H, T) fp32 = rowsum(dO * O): elementwise tensor code on
    every device, as the JAX package computes it outside its kernels."""
    return (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def _check(q, k, v, **rows):
    """Raises on anything the kernels do not take. `rows` are tensors of
    q's shape and dtype (do) or fp32 (B, H, T) statistics (lse, dres)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, Dh), got {tuple(q.shape)}")
    B, T, H, Dh = q.shape
    if min(B, T, H, Dh) < 1:
        raise ValueError(f"empty input {tuple(q.shape)}")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernels take Dh <= {MAX_HEAD_DIM}, "
                         f"got {Dh}")
    if q.dtype not in WIRE_DTYPES:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v), *rows.items()):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if name in ("lse", "dres"):
            if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, T)
                    or not t.is_contiguous()):
                raise ValueError(f"{name} must be contiguous fp32 "
                                 f"{(B, H, T)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            continue
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)} as "
                             f"q, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v),
                    *((n, t) for n, t in rows.items() if t.dim() == 4)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last axis "
                             f"(Dh), got strides {t.stride()}")


def _geometry(q, scale, p_dtype):
    B, T, H, Dh = q.shape
    return (B, T, H, Dh, float(scale), int(q.dtype == torch.bfloat16),
            int(_p_dtype(p_dtype) == torch.bfloat16), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)


def _operand(t):
    """A (B, T, H, Dh) tensor as the C entry points take it: its pointer and
    its batch, time and head strides in elements."""
    return (t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def _aligned(*tensors) -> bool:
    """Whether 16-byte copies fit every row of every tensor."""
    return all(t.data_ptr() % 16 == 0
               and all(t.stride(i) % 8 == 0 for i in range(3))
               for t in tensors)


def _route(q, p_dtype, *tensors) -> AttentionRoute:
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return attention_route(*q.shape, q.dtype, p_dtype,
                           aligned=_aligned(*tensors), sms=sms)


def _launch_fwd(q, k, v, scale, p_dtype="float32"):
    _check(q, k, v)
    lib = load_library()
    B, T, H, Dh = q.shape
    route = _route(q, p_dtype, q, k, v).forward
    if route in ("resident", "tiled") and not scale > 0:
        raise ValueError(f"the {route} forward kernel takes the row's max "
                         f"before scaling: scale must be positive, got "
                         f"{scale}")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = lib.flash_attn_fwd(*_operand(q), *_operand(k), *_operand(v),
                             o.data_ptr(), lse.data_ptr(),
                             *_geometry(q, scale, p_dtype))
    check_launch(lib, err, "flash_attention_forward")
    flash_attention_forward.launches += 1
    return o, lse


def _launch_dq(q, k, v, do, lse, dres, scale, p_dtype="float32"):
    _check(q, k, v, do=do, lse=lse, dres=dres)
    lib = load_library()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = lib.flash_attn_dq(*_operand(q), *_operand(k), *_operand(v),
                            *_operand(do), lse.data_ptr(), dres.data_ptr(),
                            dq.data_ptr(), *_geometry(q, scale, p_dtype))
    check_launch(lib, err, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


def _launch_dkv(q, k, v, do, lse, dres, scale, p_dtype="float32"):
    _check(q, k, v, do=do, lse=lse, dres=dres)
    lib = load_library()
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = lib.flash_attn_dkv(*_operand(q), *_operand(k), *_operand(v),
                             *_operand(do), lse.data_ptr(), dres.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(),
                             *_geometry(q, scale, p_dtype))
    check_launch(lib, err, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


def _launch_bwd(q, k, v, do, lse, dres, scale, p_dtype="float32"):
    _check(q, k, v, do=do, lse=lse, dres=dres)
    route = _route(q, p_dtype, q, k, v, do)
    if route.backward == "pair":
        return (_launch_dq(q, k, v, do, lse, dres, scale, p_dtype),
                *_launch_dkv(q, k, v, do, lse, dres, scale, p_dtype))
    lib = load_library()
    B, T, H, Dh = q.shape
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    partial = None
    if route.groups:  # each group's own sum of dQ, added by the 2nd launch
        partial = torch.empty((route.groups, B * H, -(-T // _TILE) * _TILE,
                               Dh), dtype=torch.float32, device=q.device)
    err = lib.flash_attn_bwd(*_operand(q), *_operand(k), *_operand(v),
                             *_operand(do), lse.data_ptr(), dres.data_ptr(),
                             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             partial.data_ptr() if route.groups else None,
                             route.groups, *_geometry(q, scale, p_dtype))
    check_launch(lib, err, "flash_attention_backward")
    flash_attention_backward.launches += 1
    return dq, dk, dv


def launch_shape(half: str, B: int, T: int, H: int, Dh: int,
                 groups: int = 0) -> Tuple[int, int, int]:
    """(blocks, threads, bytes of dynamic shared memory) of the launch the
    library makes for the tiled forward (`half` "forward") or the one-pass
    backward with `AttentionRoute.groups` = `groups` ("backward") at these
    sizes, from the launchers' own code. Needs the built library."""
    lib = load_library()
    out = (ctypes.c_int * 3)()
    err = lib.flash_attn_launch_shape(
        {"forward": 0, "backward": 1}[half], B, T, H, Dh, groups, out)
    check_launch(lib, err, "flash_attn_launch_shape")
    return tuple(out)


def launch_floor(launch: Tuple[int, int, int], device) -> None:
    """Launches an empty kernel of `launch` = (blocks, threads, bytes of
    dynamic shared memory) on `device`'s current stream: timed, it is the
    floor under a kernel of that launch (`launch_shape`)."""
    lib = load_library()
    device = torch.device(device)
    err = lib.flash_attn_empty(*launch, device.index or 0,
                               torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, "flash_attn_empty")


def flash_attention_forward(q, k, v, scale: float, p_dtype: str = "float32"):
    """(o, lse). CPU tensors run `flash_attention_forward_reference`; CUDA
    tensors run the kernel, and `flash_attention_forward.launches` counts
    its launches."""
    return on_device(q, flash_attention_forward_reference, _launch_fwd, q, k,
                     v, scale, p_dtype)


def flash_attention_dq(q, k, v, do, lse, dres, scale: float,
                       p_dtype: str = "float32"):
    """dq. CPU tensors run `flash_attention_dq_reference`; CUDA tensors run
    the kernel, and `flash_attention_dq.launches` counts its launches."""
    return on_device(q, flash_attention_dq_reference, _launch_dq, q, k, v,
                     do, lse, dres, scale, p_dtype)


def flash_attention_dkv(q, k, v, do, lse, dres, scale: float,
                        p_dtype: str = "float32"):
    """(dk, dv). CPU tensors run `flash_attention_dkv_reference`; CUDA
    tensors run the kernel, and `flash_attention_dkv.launches` counts its
    launches."""
    return on_device(q, flash_attention_dkv_reference, _launch_dkv, q, k, v,
                     do, lse, dres, scale, p_dtype)


def flash_attention_backward(q, k, v, do, lse, dres, scale: float,
                             p_dtype: str = "float32"):
    """(dq, dk, dv). CPU tensors run `flash_attention_backward_reference`;
    CUDA tensors run the kernels `attention_route` names: the one-pass
    kernel, whose launches `flash_attention_backward.launches` counts (one
    a call; on the split route the finishing kernel belongs to it), or the
    pair behind `flash_attention_dq` and `flash_attention_dkv`, which count
    their own."""
    return on_device(q, flash_attention_backward_reference, _launch_bwd, q,
                     k, v, do, lse, dres, scale, p_dtype)


flash_attention_forward.launches = 0
flash_attention_backward.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


def flash_causal_mha_reference(q, k, v, *, scale: Optional[float] = None,
                               p_dtype: str = "float32") -> torch.Tensor:
    """Plain causal multi-head attention with the kernels' numerics:
    q, k, v (B, T, H, Dh) -> o (B, T, H, Dh)."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    return flash_attention_forward_reference(q, k, v, scale, p_dtype)[0]


def flash_causal_mha_backward_reference(q, k, v, o, lse, do, *,
                                        scale: Optional[float] = None,
                                        p_dtype: str = "float32"
                                        ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the whole backward, by the kernels' explicit
    formulas (not autograd through the plain forward, which would round at
    other places): (dq, dk, dv)."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    return flash_attention_backward_reference(q, k, v, do, lse,
                                              row_dot(do, o), scale, p_dtype)


def flash_forward_folded_reference(q, k, v, scale: float,
                                   p_dtype: str = "float32"):
    """The plain forward on heads folded into the batch, the TPU wrapper's
    own layout: q, k, v (BH, T, Dh) -> (o (BH, T, Dh), lse (BH, T))."""
    o, lse = flash_attention_forward_reference(
        q[:, :, None], k[:, :, None], v[:, :, None], scale, p_dtype)
    return o[:, :, 0], lse[:, 0]


def _flash_function(name: str, forward_fn, backward_fn):
    """The autograd Function of `_flash` over one set of halves:
    (q, k, v, scale, p_dtype) -> o, as `_flash_fwd_rule` and
    `_flash_bwd_rule`."""

    def forward(ctx, q, k, v, scale, p_dtype):
        o, lse = forward_fn(q, k, v, scale, p_dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.p_dtype = scale, p_dtype
        return o

    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        dres = row_dot(do, o)
        dq, dk, dv = backward_fn(q, k, v, do, lse, dres, ctx.scale,
                                 ctx.p_dtype)
        return dq, dk, dv, None, None

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward)})


# the plain halves on any device: the CPU path, and the reference the
# kernels are held against on the card
_FlashPlain = _flash_function("_FlashPlain",
                              flash_attention_forward_reference,
                              flash_attention_backward_reference)
_FlashCuda = _flash_function("_FlashCuda", flash_attention_forward,
                             flash_attention_backward)


def flash_causal_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: Optional[float] = None,
                     p_dtype: str = "float32") -> torch.Tensor:
    """Causal multi-head attention that never stores the (T, T) scores on
    the card. q, k, v (B, T, H, Dh) -> (B, T, H, Dh), differentiable in all
    three. scale defaults to Dh**-0.5, applied to the scores in fp32 (on the
    card, bf16 inputs under 'flash16' need it positive).
    p_dtype is the operand dtype of the five post-softmax products
    ('bfloat16' is ar.attn_impl='flash16')."""
    _p_dtype(p_dtype)
    scale = float(q.shape[-1]) ** -0.5 if scale is None else float(scale)
    fn = _FlashPlain if q.device.type == "cpu" else _FlashCuda
    return fn.apply(q, k, v, scale, p_dtype)
