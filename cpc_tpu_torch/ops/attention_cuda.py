"""Causal flash attention for the transformer gar: hand-written CUDA kernels
and their plain versions.

Port of `cpc_tpu/ops/attention_pallas.py`: `flash_causal_mha` and the
custom-VJP `_flash` with `_flash_fwd_rule` / `_flash_bwd_rule`. The TPU
kernels replaced are `_fwd_kernel`, `_dq_kernel` and `_dkv_kernel`; the CUDA
kernels are `csrc/flash_attention.cu`, whose source note gives their design
and what bounds them on an H100.

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
(the three `*_reference` functions), a CUDA tensor through `_FlashCuda`,
whose halves are the kernels, which run or raise. Each kernel's wrapper
counts its launches (`flash_attention_forward.launches`, ...).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cpc_tpu_torch.ops._build import check_launch, load_library
from cpc_tpu_torch.ops.infonce import WIRE_DTYPES, on_device

NEG = -1e30  # the masked score, as the TPU kernels' _NEG
P_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_HEAD_DIM = 128  # what the kernels hold of one head in registers


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


def _launch_fwd(q, k, v, scale, p_dtype="float32"):
    _check(q, k, v)
    lib = load_library()
    B, T, H, _ = q.shape
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


flash_attention_forward.launches = 0
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
    dres = row_dot(do, o)
    dq = flash_attention_dq_reference(q, k, v, do, lse, dres, scale, p_dtype)
    dk, dv = flash_attention_dkv_reference(q, k, v, do, lse, dres, scale,
                                           p_dtype)
    return dq, dk, dv


def flash_forward_folded_reference(q, k, v, scale: float,
                                   p_dtype: str = "float32"):
    """The plain forward on heads folded into the batch, the TPU wrapper's
    own layout: q, k, v (BH, T, Dh) -> (o (BH, T, Dh), lse (BH, T))."""
    o, lse = flash_attention_forward_reference(
        q[:, :, None], k[:, :, None], v[:, :, None], scale, p_dtype)
    return o[:, :, 0], lse[:, 0]


def _flash_function(name: str, forward_fn, dq_fn, dkv_fn):
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
        args = (q, k, v, do, lse, dres, ctx.scale, ctx.p_dtype)
        dq = dq_fn(*args)
        dk, dv = dkv_fn(*args)
        return dq, dk, dv, None, None

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward)})


# the plain halves on any device: the CPU path, and the reference the
# kernels are held against on the card
_FlashPlain = _flash_function("_FlashPlain",
                              flash_attention_forward_reference,
                              flash_attention_dq_reference,
                              flash_attention_dkv_reference)
_FlashCuda = _flash_function("_FlashCuda", flash_attention_forward,
                             flash_attention_dq, flash_attention_dkv)


def flash_causal_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: Optional[float] = None,
                     p_dtype: str = "float32") -> torch.Tensor:
    """Causal multi-head attention that never stores the (T, T) scores on
    the card. q, k, v (B, T, H, Dh) -> (B, T, H, Dh), differentiable in all
    three. scale defaults to Dh**-0.5, applied to the scores in fp32.
    p_dtype is the operand dtype of the five post-softmax products
    ('bfloat16' is ar.attn_impl='flash16')."""
    _p_dtype(p_dtype)
    scale = float(q.shape[-1]) ** -0.5 if scale is None else float(scale)
    fn = _FlashPlain if q.device.type == "cpu" else _FlashCuda
    return fn.apply(q, k, v, scale, p_dtype)
