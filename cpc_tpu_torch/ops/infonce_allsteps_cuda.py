"""All-steps InfoNCE, every prediction against every latent of the pool:
hand-written CUDA kernels and their plain versions.

Port of `cpc_tpu/ops/infonce_allsteps_pallas.py`: `fused_infonce_allsteps`
and the custom-VJP `allsteps_nll` with `_fwd_rule` / `_bwd_rule`. The TPU
kernels replaced are `_fwd_kernel`, `_dp_kernel` and `_dz_kernel`; the CUDA
kernels are `csrc/infonce_allsteps.cu`, whose source note gives their design
and what bounds them on an H100.

    preds_v (B, Tp, K, D), Tp = T - K   wire dtype: float32 or bfloat16
    z_pool (C, T, D)                    the same dtype; N = C*T candidates
    nll, correct, lse (R,) fp32         R = Tp*K*B, row r = (t*K + k)*B + i

Row r is preds_v[i, t, k]; it scores in fp32 against all N rows of
z_pool.reshape(N, D), and its positive is column (shift + i)*T + t + k + 1.
Argmax ties go to the lowest column. The backward returns dpreds
(B, Tp, K, D) and dz (C, T, D) in the wire dtype: delta = (exp(s - lse) -
onehot) * g in fp32, rounded to bf16 when the wire is bf16, as `_dp_kernel`
and `_dz_kernel` round it before their second product (fp32 sums either
way); with an fp32 wire nothing is rounded.

The (R, N) scores are never stored on the device by the CUDA path. Nothing
is padded or transposed: the kernels read preds_v through its batch and
time strides, mask the ragged edges themselves, and write dpreds in place.
The TPU wrapper's tile chooser (`_tiles`) and its environment variables
have no counterpart. The plain versions do form scores, in chunks of rows
of at most `PLAIN_SCORE_BYTES`.

Dispatch is by the device of `preds_v`: a CPU tensor goes through
`_AllStepsNllPlain` (`allsteps_nll_reference`,
`allsteps_nll_backward_reference`), a CUDA tensor through
`_AllStepsNllCuda`, whose two halves are the kernels, which run or raise.
On the card `allsteps_route` names the kernels and their launch plan
("wgmma" for the bf16 training path, "simt" for the fp32 wire and what
16-byte copies do not fit); the route is passed to the C launcher, which
raises through `check_launch` if it cannot launch: neither route gives way
to the other.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from cpc_tpu_torch.ops._build import check_launch, load_library
from cpc_tpu_torch.ops.infonce import (WIRE_DTYPES, check_labels,
                                      first_argmax, on_device)
from cpc_tpu_torch.ops.infonce_cuda import (check_inputs, check_rows,
                                            nll_function)

PLAIN_SCORE_BYTES = 1 << 30  # fp32 scores a plain version forms at a time
WGMMA_MAX_D = 576  # 9 panels of 64: what a block's shared memory holds
BWD_VECTORS = 64   # vectors a wgmma backward block owns, and a swept tile
BWD_PART = 512     # D a wgmma backward block covers; more D, more blocks
H100_SMS = 132
_ROUTE_CODES = {"simt": 0, "wgmma": 1}


class AllStepsRoute(NamedTuple):
    """The kernels the card runs and their launch plan."""
    route: str    # "wgmma" or "simt"
    groups: int   # the wgmma dZ pass's row groups (1 on "simt")


def allsteps_route(R: int, N: int, D: int, dtype: torch.dtype,
                   aligned: bool = True, sms: int = H100_SMS
                   ) -> AllStepsRoute:
    """Names the kernels `allsteps_nll_forward` and `allsteps_nll_backward`
    launch on the card for R rows against N candidates of width D in
    `dtype`, and the dZ pass's row groups G. Pure Python.

    "wgmma": bf16 with D a multiple of 8 and at most WGMMA_MAX_D, pointers
    and strides 16-byte aligned (`aligned`): the training path, every
    product on wgmma. "simt": everything else, the fp32 wire (the parity
    configuration) and bf16 shapes that 16-byte copies or shared memory do
    not fit: SIMT fp32 products.

    The wgmma dZ pass owns 64-column tiles, one block for each tile and
    512-wide part of D; where those are fewer than `sms` it splits the R
    rows into G groups of 64-row tiles, so that the blocks cover every SM
    (G = 2 at tpu_fast, N = 8 192; 1 where the columns alone fill the card),
    never more groups than row tiles. Raises on inputs that no kernel
    takes."""
    if dtype not in WIRE_DTYPES:
        raise TypeError(f"preds_v and z_pool must be one of {WIRE_DTYPES}, "
                        f"got {dtype}")
    if min(R, N, D, sms) < 1:
        raise ValueError(f"empty shape (R, N, D) = {(R, N, D)}, sms {sms}")
    if not (dtype == torch.bfloat16 and D % 8 == 0 and D <= WGMMA_MAX_D
            and aligned):
        return AllStepsRoute("simt", 1)
    per_group = math.ceil(N / BWD_VECTORS) * math.ceil(D / BWD_PART)
    groups = min(math.ceil(R / BWD_VECTORS), math.ceil(sms / per_group))
    return AllStepsRoute("wgmma", groups)


def _row_chunks(preds_v: torch.Tensor, z_pool: torch.Tensor, shift: int):
    """Yields (rows, p (n, D) fp32, labels (n,)) over chunks of whole steps
    t: `rows` is the slice of r = (t*K + k)*B + i the chunk covers."""
    B, Tp, K, D = preds_v.shape
    C, T, _ = z_pool.shape
    dev = preds_v.device
    steps = max(1, PLAIN_SCORE_BYTES // (4 * C * T * K * B))
    k = torch.arange(K, device=dev)[None, :, None]
    i = torch.arange(B, device=dev)[None, None, :]
    for t0 in range(0, Tp, steps):
        t1 = min(Tp, t0 + steps)
        t = torch.arange(t0, t1, device=dev)[:, None, None]
        labels = ((shift + i) * T + (t + k + 1)).reshape(-1)
        p = preds_v[:, t0:t1].permute(1, 2, 0, 3).reshape(-1, D).float()
        yield slice(t0 * K * B, t1 * K * B), p, labels


def allsteps_nll_reference(preds_v: torch.Tensor, z_pool: torch.Tensor,
                           shift: int):
    """Plain version of the forward kernel: (nll, correct, lse), each (R,)
    fp32."""
    zf = z_pool.reshape(-1, z_pool.shape[2]).float()
    nll, correct, lse = [], [], []
    for _, p, labels in _row_chunks(preds_v, z_pool, shift):
        s = p @ zf.T
        m = s.max(dim=-1, keepdim=True).values
        row_lse = m[:, 0] + torch.log(torch.exp(s - m).sum(dim=-1))
        nll.append(row_lse - s.gather(1, labels[:, None])[:, 0])
        correct.append((first_argmax(s) == labels).float())
        lse.append(row_lse)
    return torch.cat(nll), torch.cat(correct), torch.cat(lse)


def allsteps_nll_backward_reference(g_nll: torch.Tensor, lse: torch.Tensor,
                                    preds_v: torch.Tensor,
                                    z_pool: torch.Tensor, shift: int):
    """Plain version of the backward kernels: (dpreds (B, Tp, K, D),
    dz (C, T, D)) in the inputs' dtype, from the cotangent g_nll (R,) and
    the forward's lse."""
    B, Tp, K, D = preds_v.shape
    zf = z_pool.reshape(-1, D).float()
    dp = torch.empty((Tp * K * B, D), dtype=torch.float32,
                     device=preds_v.device)
    dz = torch.zeros_like(zf)
    for rows, p, labels in _row_chunks(preds_v, z_pool, shift):
        delta = torch.exp(p @ zf.T - lse[rows, None])
        delta[torch.arange(len(labels)), labels] -= 1.0
        delta *= g_nll[rows, None].float()
        # a bf16 wire rounds delta; bf16 x bf16 products are exact in fp32,
        # so these are the kernels' "bf16 operands, fp32 sums" products
        delta = delta.to(preds_v.dtype).float()
        dp[rows] = delta @ zf
        dz += delta.T @ p
    dpreds = dp.reshape(Tp, K, B, D).permute(2, 0, 1, 3)
    return (dpreds.to(preds_v.dtype).contiguous(),
            dz.to(z_pool.dtype).reshape(z_pool.shape))


def _route(preds_v, z_pool) -> AllStepsRoute:
    B, Tp, K, D = preds_v.shape
    aligned = (preds_v.data_ptr() % 16 == 0 and z_pool.data_ptr() % 16 == 0
               and preds_v.stride(0) % 8 == 0 and preds_v.stride(1) % 8 == 0)
    sms = torch.cuda.get_device_properties(
        preds_v.device).multi_processor_count
    return allsteps_route(Tp * K * B, z_pool.shape[0] * z_pool.shape[1], D,
                          preds_v.dtype, aligned, sms)


def _geometry(preds_v, z_pool, shift):
    B, _, K, D = preds_v.shape
    C, T, _ = z_pool.shape
    return (T, B, C, K, D, shift, preds_v.stride(0), preds_v.stride(1),
            int(preds_v.dtype == torch.bfloat16))


def _where(preds_v):
    return (preds_v.device.index,
            torch.cuda.current_stream(preds_v.device).cuda_stream)


def _check(preds_v, z_pool, shift):
    check_inputs(preds_v, z_pool, shift)
    if not z_pool.is_contiguous():
        raise ValueError("z_pool must be contiguous: its (C*T, D) view is "
                         "the candidate matrix")


def _launch_fwd(preds_v, z_pool, shift):
    _check(preds_v, z_pool, shift)
    lib = load_library()
    B, Tp, K, _ = preds_v.shape
    outs = [torch.empty((Tp * K * B,), dtype=torch.float32,
                        device=preds_v.device) for _ in range(3)]
    err = lib.allsteps_nll_fwd(
        preds_v.data_ptr(), z_pool.data_ptr(), *(o.data_ptr() for o in outs),
        *_geometry(preds_v, z_pool, shift),
        _ROUTE_CODES[_route(preds_v, z_pool).route], *_where(preds_v))
    check_launch(lib, err, "allsteps_nll_forward")
    allsteps_nll_forward.launches += 1
    return tuple(outs)


def _launch_bwd(g_nll, lse, preds_v, z_pool, shift):
    _check(preds_v, z_pool, shift)
    B, Tp, K, D = preds_v.shape
    check_rows(preds_v, (Tp * K * B,), g_nll=g_nll, lse=lse)
    lib = load_library()
    dpreds = torch.empty(preds_v.shape, dtype=preds_v.dtype,
                         device=preds_v.device)
    dz = torch.empty_like(z_pool)
    plan = _route(preds_v, z_pool)
    part = rows = None
    if plan.route == "wgmma":
        # the dZ pass's fp32 partials, one (N, D) a row group; and preds as
        # a contiguous (R, D) matrix in row order, which its TMA map reads
        # (91 MB at tpu_fast: one copy)
        part = torch.empty((plan.groups, *dz.shape), dtype=torch.float32,
                           device=dz.device)
        rows = preds_v.permute(1, 2, 0, 3).reshape(-1, D).contiguous()
    err = lib.allsteps_nll_bwd(
        g_nll.data_ptr(), lse.data_ptr(), preds_v.data_ptr(),
        z_pool.data_ptr(), dpreds.data_ptr(), dz.data_ptr(),
        None if part is None else part.data_ptr(),
        None if rows is None else rows.data_ptr(),
        *_geometry(preds_v, z_pool, shift), _ROUTE_CODES[plan.route],
        plan.groups, *_where(preds_v))
    check_launch(lib, err, "allsteps_nll_backward")
    allsteps_nll_backward.launches += 1
    return dpreds, dz


def allsteps_nll_forward(preds_v: torch.Tensor, z_pool: torch.Tensor,
                         shift: int):
    """(nll, correct, lse). CPU tensors run `allsteps_nll_reference`; CUDA
    tensors run the kernel, and `allsteps_nll_forward.launches` counts its
    launches."""
    return on_device(preds_v, allsteps_nll_reference, _launch_fwd, preds_v,
                     z_pool, shift)


def allsteps_nll_backward(g_nll: torch.Tensor, lse: torch.Tensor,
                          preds_v: torch.Tensor, z_pool: torch.Tensor,
                          shift: int):
    """(dpreds, dz). CPU tensors run `allsteps_nll_backward_reference`; CUDA
    tensors run the kernels (dP, dZ and, on "wgmma", the finishing sum of
    dZ's row groups), and `allsteps_nll_backward.launches` counts one a
    call."""
    return on_device(preds_v, allsteps_nll_backward_reference, _launch_bwd,
                     g_nll, lse, preds_v, z_pool, shift)


allsteps_nll_forward.launches = 0
allsteps_nll_backward.launches = 0

_AllStepsNllPlain = nll_function("_AllStepsNllPlain", allsteps_nll_reference,
                                 allsteps_nll_backward_reference)
_AllStepsNllCuda = nll_function("_AllStepsNllCuda", allsteps_nll_forward,
                                allsteps_nll_backward)


def allsteps_nll(preds_v: torch.Tensor, z_pool: torch.Tensor,
                 shift: int = 0):
    """preds_v (B, Tp, K, D), z_pool (C, T, D) -> (nll, correct), each (R,)
    fp32 with row r = (t*K + k)*B + i, differentiable in preds_v and
    z_pool."""
    fn = _AllStepsNllPlain if preds_v.device.type == "cpu" \
        else _AllStepsNllCuda
    return fn.apply(preds_v, z_pool.contiguous(), int(shift))


def reduce_allsteps_nll(nll: torch.Tensor, correct: torch.Tensor, Tp: int,
                        K: int, B: int
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss", "acc" (K,), "acc_mean"}) from the (R,) rows."""
    loss = nll.mean()
    acc = correct.reshape(Tp, K, B).mean(dim=(0, 2))
    return loss, {"loss": loss, "acc": acc, "acc_mean": acc.mean()}


def fused_infonce_allsteps(
    preds_v: torch.Tensor,
    z_pool: torch.Tensor,
    *,
    shift: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and per-k accuracy with the full C*T candidate pool, through the
    kernels. preds_v (B, Tp, K, D); z_pool (C, T, D), whose rows
    shift..shift+B-1 are this batch's sequences."""
    B, Tp, K, _ = preds_v.shape
    check_labels(B, z_pool.shape[0], int(shift))
    nll, correct = allsteps_nll(preds_v, z_pool, shift)
    return reduce_allsteps_nll(nll, correct, Tp, K, B)
