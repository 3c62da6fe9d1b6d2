"""GRU recurrence, forward and backward: hand-written CUDA kernels and their
plain versions.

Port of `cpc_tpu/ops/gru_pallas.py::gru_scan` and its custom VJP
(`_fwd_kernel` and `_bwd_kernel` are the TPU kernels replaced). The kernels
are in `csrc/gru_scan.cu`; its source note gives the design and what bounds
them on an H100.

    xproj (T, B, 3H), wh (H, 3H)   wire dtype: float32 or bfloat16
    bh (3H,)                       float32 or the wire dtype (used in fp32)
    h0 (B, H)                      float32
    -> hs (T, B, H)                wire dtype

Semantics shared by both versions, as in the Pallas kernel: torch.nn.GRU
gates in the order r, z, n, computed in fp32; h carried in fp32 and rounded
to wh's dtype only for the recurrent product, which accumulates in fp32;
only the output is rounded to the wire dtype.

The backward has the Pallas backward's numerics (`_bwd_rule`): h_{t-1} is
the forward's output rounded to the wire dtype (round(h0) at t = 0), the
gates are recomputed from round(h_{t-1}) @ wh + bh in fp32, the recurrent
gradient dh is carried in fp32, dwh and dbh are summed in fp32, and the
results are cast to the dtypes of xproj, wh, bh and h0.

The backward kernels are three stages (`csrc/gru_scan.cu`): the gates of
all T*B rows at once, the reversed recurrence that consumes them, and the
sums for dwh and dbh. `gru_gates_reference` and
`gru_scan_backward_split_reference` are that split in plain PyTorch, equal
to `gru_scan_backward_reference` bit for bit.

Dispatch is by the device of `xproj`: a CPU tensor goes through
`_GruScanPlain` (`gru_scan_reference` forward, `gru_scan_backward_reference`
backward), a CUDA tensor through `_GruScanCuda`, whose forward and backward
are the kernels, which run or raise. On the card `gru_route` names the
kernels a shape takes: "resident" (wh kept in the shared memory of a
thread-block cluster; every preset) or "streamed" (wh read from L2 every
step; the widths the cluster does not take). A route that cannot launch
raises; neither gives way to the other.
"""

from __future__ import annotations

import torch

from cpc_tpu_torch.ops._build import check_launch, load_library

_WIRE_DTYPES = (torch.float32, torch.bfloat16)
_RESIDENT_HIDDEN = (32, 64, 128, 256)  # H / 32 blocks a cluster, at most 8
_TILE_ROWS = 8  # batch rows a cluster of the resident route (8 or 16)


def gru_route(B: int, H: int, dtype: torch.dtype) -> str:
    """The kernels that `gru_scan` and `gru_scan_backward` launch for batch
    B, width H and wire dtype `dtype` on the card: "resident" or "streamed"
    (module docstring). The resident route takes the widths that are 1, 2,
    4 or 8 warps of hidden units (a cluster of H / 32 blocks, each holding
    its 32 units' slice of wh: at most 96 KB, in fp32 at H = 256), at any
    batch and in both dtypes."""
    if dtype not in _WIRE_DTYPES:
        raise TypeError(f"dtype {dtype} not in {_WIRE_DTYPES}")
    if B < 1 or H < 1:
        raise ValueError(f"empty shape B={B}, H={H}")
    return "resident" if H in _RESIDENT_HIDDEN else "streamed"


def _tile_rows(xproj: torch.Tensor) -> int:
    """The C entry points' `tile_rows`: 0 on the streamed route."""
    _, B, H3 = xproj.shape
    resident = gru_route(B, H3 // 3, xproj.dtype) == "resident"
    return _TILE_ROWS if resident else 0


def gru_scan_reference(xproj: torch.Tensor, wh: torch.Tensor,
                       bh: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a Python loop over T."""
    T, B, H3 = xproj.shape
    H = H3 // 3
    w32 = wh.float()
    b32 = bh.float()
    h = h0.float()
    outs = []
    for t in range(T):
        # bf16 x bf16 products are exact in fp32, so this is the kernel's
        # "round h to wh's dtype, accumulate in fp32" product
        hp = h.to(wh.dtype).float() @ w32 + b32
        xr, xz, xn = xproj[t].float().split(H, dim=-1)
        hr, hz, hn = hp.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        outs.append(h.to(xproj.dtype))
    return torch.stack(outs)


def gru_scan_backward_reference(xproj, wh, bh, h0, hs, g):
    """Plain PyTorch version of the backward kernel: an explicit reversed
    loop over T with the Pallas backward's numerics (module docstring).
    hs (T, B, H) is the forward's output, g (T, B, H) its cotangent.
    Returns (dxproj, dwh, dbh, dh0)."""
    T, B, H3 = xproj.shape
    H = H3 // 3
    w32 = wh.float()
    b32 = bh.float()
    hprev = torch.cat([h0.to(hs.dtype)[None], hs[:-1]]).float()
    dh = torch.zeros(B, H, dtype=torch.float32, device=xproj.device)
    dwh = torch.zeros(H, H3, dtype=torch.float32, device=xproj.device)
    dbh = torch.zeros(H3, dtype=torch.float32, device=xproj.device)
    dxproj = torch.empty_like(xproj)
    for t in range(T - 1, -1, -1):
        h_prev = hprev[t]
        hp = h_prev.to(wh.dtype).float() @ w32 + b32
        xr, xz, xn = xproj[t].float().split(H, dim=-1)
        hr, hz, hn = hp.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh = dh + g[t].float()               # total dL/dh_t
        dz = dh * (h_prev - n)
        dn_pre = dh * (1.0 - z) * (1.0 - n * n)
        dhn = dn_pre * r                      # into (h @ Whn + bhn)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dxproj[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dhp = torch.cat([dr_pre, dz_pre, dhn], dim=-1)
        dwh += h_prev.T @ dhp
        dbh += dhp.sum(0)
        dh = dh * z + dhp @ w32.T
    return dxproj, dwh.to(wh.dtype), dbh.to(bh.dtype), dh.to(h0.dtype)


def gru_gates_reference(xproj, wh, bh, h0, hs):
    """Stage 1 of the backward in plain PyTorch: the gates of every step
    from h_{t-1} = (round(h0), hs[:-1]), none of which depends on the
    reversed recurrence. Returns (r, z, n, hn), each (T, B, H) fp32. The
    product is made step by step, with the shapes
    `gru_scan_backward_reference` gives it, so the two agree bit for bit."""
    T, B, H3 = xproj.shape
    H = H3 // 3
    w32 = wh.float()
    b32 = bh.float()
    hprev = torch.cat([h0.to(hs.dtype)[None], hs[:-1]]).float()
    gates = []
    for t in range(T):
        hp = hprev[t].to(wh.dtype).float() @ w32 + b32
        xr, xz, xn = xproj[t].float().split(H, dim=-1)
        hr, hz, hn = hp.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        gates.append(torch.stack([r, z, torch.tanh(xn + r * hn), hn]))
    r, z, n, hn = torch.stack(gates, dim=1)
    return r, z, n, hn


def gru_scan_backward_split_reference(xproj, wh, bh, h0, hs, g):
    """The backward as the kernels split it, in plain PyTorch: stage 1
    (`gru_gates_reference`), the reversed recurrence that only consumes its
    gates and writes dxproj and dhp, and the sums for dwh and dbh over the
    stored dhp, in the recurrence's order. Returns (dxproj, dwh, dbh, dh0)
    as `gru_scan_backward_reference`."""
    T, B, H3 = xproj.shape
    H = H3 // 3
    w32 = wh.float()
    r, z, n, hn = gru_gates_reference(xproj, wh, bh, h0, hs)
    hprev = torch.cat([h0.to(hs.dtype)[None], hs[:-1]]).float()
    dh = torch.zeros(B, H, dtype=torch.float32, device=xproj.device)
    dxproj = torch.empty_like(xproj)
    dhp = torch.empty((T, B, H3), dtype=torch.float32, device=xproj.device)
    for t in range(T - 1, -1, -1):
        dh = dh + g[t].float()
        dz = dh * (hprev[t] - n[t])
        dn_pre = dh * (1.0 - z[t]) * (1.0 - n[t] * n[t])
        dhn = dn_pre * r[t]
        dr_pre = dn_pre * hn[t] * r[t] * (1.0 - r[t])
        dz_pre = dz * z[t] * (1.0 - z[t])
        dxproj[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dhp[t] = torch.cat([dr_pre, dz_pre, dhn], dim=-1)
        dh = dh * z[t] + dhp[t] @ w32.T
    dwh = torch.zeros(H, H3, dtype=torch.float32, device=xproj.device)
    dbh = torch.zeros(H3, dtype=torch.float32, device=xproj.device)
    for t in range(T - 1, -1, -1):
        dwh += hprev[t].T @ dhp[t]
        dbh += dhp[t].sum(0)
    return dxproj, dwh.to(wh.dtype), dbh.to(bh.dtype), dh.to(h0.dtype)


def _check(xproj, wh, bh, h0, hs=None, g=None) -> None:
    """Raises on anything the kernels do not take (hs and g: the backward's
    extra inputs)."""
    if xproj.dim() != 3 or xproj.shape[2] % 3:
        raise ValueError(f"xproj must be (T, B, 3H), got {tuple(xproj.shape)}")
    T, B, H3 = xproj.shape
    H = H3 // 3
    if min(T, B, H) < 1:
        raise ValueError(f"empty xproj {tuple(xproj.shape)}")
    if xproj.dtype not in _WIRE_DTYPES:
        raise TypeError(f"xproj dtype {xproj.dtype} not in {_WIRE_DTYPES}")
    if wh.dtype != xproj.dtype:
        raise TypeError(f"wh dtype {wh.dtype} != xproj dtype {xproj.dtype}")
    if bh.dtype not in (torch.float32, xproj.dtype):
        raise TypeError(f"bh dtype {bh.dtype}: need float32 or "
                        f"{xproj.dtype}")
    if h0.dtype != torch.float32:
        raise TypeError(f"h0 must be float32, got {h0.dtype}")
    for name, t, shape in (("wh", wh, (H, H3)), ("bh", bh, (H3,)),
                           ("h0", h0, (B, H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    extra = [(n, t) for n, t in (("hs", hs), ("g", g)) if t is not None]
    for name, t in extra:
        if t.dtype != xproj.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != xproj dtype "
                            f"{xproj.dtype}")
        if tuple(t.shape) != (T, B, H):
            raise ValueError(f"{name} must be {(T, B, H)}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("xproj", xproj), ("wh", wh), ("bh", bh), ("h0", h0),
                    *extra):
        if t.device != xproj.device:
            raise ValueError(f"{name} on {t.device}, xproj on {xproj.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library(xproj, wh, bh, h0, hs=None, g=None):
    """The kernels' library, after every check of the inputs."""
    _check(xproj, wh, bh, h0, hs, g)
    lib = load_library()
    H = xproj.shape[2] // 3
    if H > lib.gru_scan_max_hidden():
        raise ValueError(f"gru_scan kernels take H <= "
                         f"{lib.gru_scan_max_hidden()} (one thread per "
                         f"hidden unit), got H={H}")
    return lib


def _launch(xproj, wh, bh, h0) -> torch.Tensor:
    lib = _library(xproj, wh, bh, h0)
    T, B, H3 = xproj.shape
    H = H3 // 3
    # freeing this copy after the launch is safe: the caching allocator
    # reuses it only for work queued later on the same stream
    b32 = bh.float()
    out = torch.empty((T, B, H), dtype=xproj.dtype, device=xproj.device)
    stream = torch.cuda.current_stream(xproj.device)
    err = lib.gru_scan_fwd(
        xproj.data_ptr(), wh.data_ptr(), b32.data_ptr(), h0.data_ptr(),
        out.data_ptr(), T, B, H, _tile_rows(xproj),
        int(xproj.dtype == torch.bfloat16), xproj.device.index,
        stream.cuda_stream)
    check_launch(lib, err, "gru_scan")
    gru_scan.launches += 1
    return out


_ROWS_PER_SPLIT = 512  # T*B rows per partial sum of dwh and dbh


def _launch_bwd(xproj, wh, bh, h0, hs, g):
    lib = _library(xproj, wh, bh, h0, hs, g)
    T, B, H3 = xproj.shape
    H = H3 // 3
    splits = min(max(1, -(-T * B // _ROWS_PER_SPLIT)), 64)
    dev, f32 = xproj.device, torch.float32
    # these temporaries are freed after the launch, which is safe: the
    # caching allocator reuses them only for work queued later on the stream
    b32 = bh.float()
    tile_rows = _tile_rows(xproj)
    # stage 1's gates (r, z, n, hn), which only the resident route stores
    gates = torch.empty((T * B * 4 * H if tile_rows else 0,), dtype=f32,
                        device=dev)
    dxproj = torch.empty_like(xproj)
    dhp = torch.empty((T, B, H3), dtype=f32, device=dev)
    dh0 = torch.empty((B, H), dtype=f32, device=dev)
    pdwh = torch.empty((splits, H, H3), dtype=f32, device=dev)
    pdbh = torch.empty((splits, H3), dtype=f32, device=dev)
    dwh = torch.empty((H, H3), dtype=wh.dtype, device=dev)
    dbh = torch.empty((H3,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev)
    err = lib.gru_scan_bwd(
        xproj.data_ptr(), wh.data_ptr(), b32.data_ptr(), h0.data_ptr(),
        hs.data_ptr(), g.data_ptr(), dxproj.data_ptr(), dhp.data_ptr(),
        dh0.data_ptr(), pdwh.data_ptr(), pdbh.data_ptr(), dwh.data_ptr(),
        dbh.data_ptr(), gates.data_ptr(), T, B, H, splits, tile_rows,
        int(xproj.dtype == torch.bfloat16), dev.index, stream.cuda_stream)
    check_launch(lib, err, "gru_scan_backward")
    gru_scan_backward.launches += 1
    return dxproj, dwh, dbh.to(bh.dtype), dh0


def gru_scan_backward(xproj, wh, bh, h0, hs, g):
    """The backward: (dxproj, dwh, dbh, dh0) from the forward's inputs, its
    output hs and the cotangent g. CPU tensors run
    `gru_scan_backward_reference`; CUDA tensors run the kernels, and
    `gru_scan_backward.launches` counts the launches."""
    if xproj.device.type == "cpu":
        return gru_scan_backward_reference(xproj, wh, bh, h0, hs, g)
    if xproj.device.type != "cuda":
        raise ValueError(f"gru_scan runs on cpu or cuda, not {xproj.device}")
    return _launch_bwd(xproj, wh, bh, h0, hs, g)


gru_scan_backward.launches = 0


def cluster_exchange_probe(steps: int, hidden: int,
                           device: torch.device) -> torch.Tensor:
    """Launches, on one cluster, `steps` times the exchange and the cluster
    barrier of the resident forward without its product: the serial floor
    that no product can get under, for a caller to time. Returns the
    kernel's sink tensor."""
    lib = load_library()
    device = torch.device(device)
    sink = torch.empty((8 * 256,), dtype=torch.float32, device=device)
    err = lib.gru_exchange_probe(
        sink.data_ptr(), steps, hidden, _TILE_ROWS, device.index or 0,
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, "gru_exchange_probe")
    return sink


class _GruScanPlain(torch.autograd.Function):
    """The plain forward and backward, on any device: the CPU path, and the
    reference the kernels are held against on the card."""

    @staticmethod
    def forward(ctx, xproj, wh, bh, h0):
        hs = gru_scan_reference(xproj, wh, bh, h0)
        ctx.save_for_backward(xproj, wh, bh, h0, hs)
        return hs

    @staticmethod
    def backward(ctx, grad):
        return gru_scan_backward_reference(*ctx.saved_tensors,
                                           grad.contiguous())


class _GruScanCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xproj, wh, bh, h0):
        hs = _launch(xproj, wh, bh, h0)
        ctx.save_for_backward(xproj, wh, bh, h0, hs)
        return hs

    @staticmethod
    def backward(ctx, grad):
        xproj, wh, bh, h0, hs = ctx.saved_tensors
        return _launch_bwd(xproj, wh, bh, h0, hs,
                           grad.to(hs.dtype).contiguous())


def gru_scan(xproj: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
             h0: torch.Tensor) -> torch.Tensor:
    """xproj (T, B, 3H), wh (H, 3H), bh (3H,), h0 (B, H) -> hs (T, B, H).

    CPU tensors run `gru_scan_reference`; CUDA tensors run the kernel, and
    `gru_scan.launches` counts its launches. Differentiable: the backward
    is `gru_scan_backward_reference` on the CPU and the backward kernels on
    CUDA."""
    if xproj.device.type == "cpu":
        return _GruScanPlain.apply(xproj, wh, bh, h0)
    if xproj.device.type != "cuda":
        raise ValueError(f"gru_scan runs on cpu or cuda, not {xproj.device}")
    return _GruScanCuda.apply(xproj, wh, bh, h0)


gru_scan.launches = 0
