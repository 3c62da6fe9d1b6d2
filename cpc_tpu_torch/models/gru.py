"""gar: multi-layer GRU context network.

Port of `cpc_tpu/models/gru.py::GRU` and `_GRULayer`. Each layer makes ONE
input projection for all T (a (B*T, D) x (D, 3H) matmul), then runs the
recurrence through `ops.gru_cuda.gru_scan`: the hand-written CUDA kernel
for a CUDA tensor, its plain PyTorch version for a CPU tensor. Gate order
r, z, n as in torch.nn.GRU; weights keep the JAX package's layout (wi
(D, 3H), wh (H, 3H)) and names (`layer{n}.wi`, ...).

The recurrence has the Pallas kernel's numerics (gates and carried h in
fp32, output rounded to the compute dtype), which is what the JAX package
runs with `ar.use_pallas=True`. `use_pallas` is taken from `cfg.model.ar`
and kept on the module, and both settings run `gru_scan`: the JAX package's
`lax.scan` path, taken with `use_pallas=False`, equals the kernel's in fp32,
and in bf16, where it carries h in bf16, the port's c is within 1.4e-2 of it
with the modules' own initialisation (T = 128; the band of the other bf16
GRU tests is 2e-2). A tensor-code recurrence that carries h in bf16 lands as
far from it (1.4e-2: two bf16 scans round at different places), so it would
buy no agreement and lose the kernel; the measurement is in
tests/test_torch_port_gru_resident.py. The JAX package's v5e envelope
fallback (B > 384 or H > 256) is not carried over: a CUDA tensor runs the
kernel or raises.

A graph being exported (`export.py`) runs `gru_scan_reference` instead,
on any device, since the kernel's ctypes launch cannot be traced into a
graph (`ops.conv_cuda.conv1d` routes on the same test). Every other caller
keeps the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cpc_tpu_torch.models._init import lecun_normal_
from cpc_tpu_torch.ops.gru_cuda import gru_scan, gru_scan_reference


class _GRULayer(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, dtype,
                 param_dtype, generator: Optional[torch.Generator],
                 use_pallas: bool = False):
        super().__init__()
        D, H = input_size, hidden_size
        self.dtype = dtype
        self.use_pallas = use_pallas  # either way gru_scan (module docstring)
        self.wi = nn.Parameter(lecun_normal_(
            torch.empty(D, 3 * H, dtype=param_dtype), D, generator))
        self.bi = nn.Parameter(torch.zeros(3 * H, dtype=param_dtype))
        wh = torch.empty(H, 3 * H, dtype=param_dtype)
        self.wh = nn.Parameter(nn.init.orthogonal_(wh, generator=generator))
        self.bh = nn.Parameter(torch.zeros(3 * H, dtype=param_dtype))

    def scan_inputs(self, x: torch.Tensor, h0: Optional[torch.Tensor]):
        """(xproj (T, B, 3H), wh, bh, h0 fp32): gru_scan's arguments for
        x (B, T, D), in the compute dtype."""
        B, T, D = x.shape
        H = self.wh.shape[0]
        x = x.to(self.dtype)
        xproj = x.reshape(B * T, D) @ self.wi.to(self.dtype) \
            + self.bi.to(self.dtype)
        xproj = xproj.reshape(B, T, 3 * H).transpose(0, 1).contiguous()
        if h0 is None:
            h0 = torch.zeros(B, H, dtype=torch.float32, device=x.device)
        return (xproj, self.wh.to(self.dtype).contiguous(),
                self.bh.to(self.dtype), h0.float().contiguous())

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
                time_major_out: bool = False) -> torch.Tensor:
        scan = (gru_scan_reference if torch.compiler.is_exporting()
                else gru_scan)
        hs = scan(*self.scan_inputs(x, h0))  # (T, B, H)
        return hs if time_major_out else hs.transpose(0, 1)


class GRU(nn.Module):
    """Multi-layer unidirectional GRU. Input (B, T, D) -> (B, T, H)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dtype=torch.float32, param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 use_pallas: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.use_pallas = use_pallas
        for n in range(num_layers):
            self.add_module(f"layer{n}", _GRULayer(
                input_size if n == 0 else hidden_size, hidden_size, dtype,
                param_dtype, generator, use_pallas))

    def layers(self):
        return [getattr(self, f"layer{n}") for n in range(self.num_layers)]

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
                return_state: bool = False, time_major_out: bool = False):
        """h0/state layout: (num_layers, B, H). With return_state, returns
        (output, final_state); feeding final_state back as h0 continues the
        recurrence. time_major_out returns (T, B, H), the recurrence's
        native layout. As in the JAX package, the final state is the last
        output row, in the compute dtype."""
        h = x
        finals = []
        for n, layer in enumerate(self.layers()):
            tm = time_major_out and n == self.num_layers - 1
            h = layer(h, None if h0 is None else h0[n], time_major_out=tm)
            if return_state:
                finals.append(h[-1] if tm else h[:, -1])
        if return_state:
            return h, torch.stack(finals)
        return h
