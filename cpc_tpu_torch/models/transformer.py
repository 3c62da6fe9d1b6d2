"""gar variant: causal transformer context network.

Port of `cpc_tpu/models/transformer.py`: `FlashSelfAttention`, `_Block`,
`CausalTransformer`, `decode_carry` and `carry_decode_model`. Pre-LN causal
self-attention blocks with a learned positional embedding; z (B, T, D) ->
c (B, T, d_ar), strictly causal.

`ar.attn_impl`:

  * 'xla' (default): plain tensor code with flax's
    MultiHeadDotProductAttention numerics: q / sqrt(Dh) in the compute
    dtype, a finfo-min causal mask, softmax in the compute dtype,
    attention-weight dropout (one (T, T) mask shared by batch and heads, as
    flax broadcasts it). In the JAX package this path is XLA's own, not a
    Pallas kernel.
  * 'flash' | 'flash16': `ops.attention_cuda.flash_causal_mha`, the
    hand-written CUDA kernels for a CUDA tensor and their plain versions
    for a CPU tensor, with the post-softmax products fed fp32 | bf16. On
    the card a bf16 model under 'flash16' runs the tiled forward kernel
    (one block a head up to T = 128) and the one-pass backward kernel (dq,
    dk and dv from one sweep), each once a layer; under 'flash', and an
    fp32 model under either, their own forward and the pair of dQ and
    dK/dV kernels (`ops.attention_cuda.attention_route` names them). No
    dropout (the kernels have none).
  * 'ring' | 'zigzag' (context parallelism): z is this rank's time shard
    and attention runs `ops.attention_ring.ring_causal_mha` or
    `ops.attention_zigzag.zigzag_causal_mha` over the ring of the mesh's
    `cp_axis` (`RingSelfAttention`); the positional table is read at the
    shard's global offset, and R * T_loc must not exceed max_len. The
    forward must run inside `ops.ring_util.axis_env(mesh)`, as the JAX
    module must run inside shard_map: `parallel/cp.py` sets it. Their
    scores are fp32 products scaled by Dh**-0.5 with -1e30 masks, as the
    JAX ring computes them; no dropout.

Every impl has the same parameters (`SelfAttention`'s query, key, value and
out projections), so one `state_dict` loads under each. Where PyTorch's
defaults differ from flax's, flax's are kept: LayerNorm eps 1e-6 with its
statistics in fp32, gelu in its tanh form, params kept in `param_dtype` and
cast to the compute `dtype` at use.

Dropout (`ar.dropout > 0`, 'xla' only) is live when `train=True` and draws
from an explicit `torch.Generator` on the tensors' device; its draws are
not JAX's. `ar.remat` recomputes each block in the backward
(`torch.utils.checkpoint`), replaying the block's dropout draws.

`decode_step` is the incremental KV-cache path in plain tensor code: one
new latent per stream, the cache an explicit carry (`decode_carry`) with a
position per stream. It accepts both carry forms, a tuple of per-layer
buffers and one stacked (L, B, S, H, Dh) tensor, and writes the new keys
and values into the buffers it was given, in place, where the JAX step
returns new arrays; `pos` is returned new. The streaming extractor around
it is `eval/streaming.py::StreamingExtractor`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cpc_tpu_torch.config import ArConfig
from cpc_tpu_torch.models._init import Dense
from cpc_tpu_torch.ops.attention_cuda import flash_causal_mha
from cpc_tpu_torch.ops.attention_ring import ring_causal_mha
from cpc_tpu_torch.ops.attention_zigzag import zigzag_causal_mha
from cpc_tpu_torch.ops.ring_util import current_mesh

ATTN_IMPLS = ("xla", "flash", "flash16", "ring", "zigzag")


class _LayerNorm(nn.LayerNorm):
    """flax LayerNorm: eps 1e-6, computed in fp32, rounded once to the
    compute dtype."""

    def __init__(self, d: int, dtype, param_dtype):
        super().__init__(d, eps=1e-6, dtype=param_dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.dtype)


def _sqrt_in(dtype, dh: int) -> float:
    """sqrt(Dh) rounded to the compute dtype, the divisor flax MHA uses."""
    return torch.tensor(math.sqrt(dh), dtype=dtype).item()


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: keeps an entry with probability 1 - rate and scales
    it by 1 / (1 - rate). Off unless `train`."""
    if not train or rate <= 0.0:
        return x
    keep = keep_mask(x.shape, rate, x.device, generator)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def keep_mask(shape, rate: float, device,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        raise ValueError("ar.dropout > 0 with train=True needs a "
                         "torch.Generator for its draws")
    return torch.rand(tuple(shape), generator=generator,
                      device=device) >= rate


class SelfAttention(nn.Module):
    """Causal self-attention with flax MHA's parameters (query, key, value
    projections d -> (H, Dh), flattened with feature h*Dh + e, and the
    merged `out` projection) and, in this class, flax MHA's numerics: the
    'xla' path."""

    def __init__(self, num_heads: int, d_model: int, dtype, param_dtype,
                 dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_ar {d_model} not divisible by num_heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(d_model, d_model, dtype, param_dtype,
                                        generator))

    def heads(self, proj: Dense, x: torch.Tensor) -> torch.Tensor:
        """(B, T, d) -> (B, T, H, Dh), a view of the projection's output."""
        B, T, d = x.shape
        return proj(x).view(B, T, self.num_heads, d // self.num_heads)

    def attend(self, q, k, v, train: bool, generator):
        B, T, H, Dh = q.shape
        q = q / _sqrt_in(q.dtype, Dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal, torch.finfo(scores.dtype).min)
        w = torch.softmax(scores, dim=-1)
        if train and self.dropout_rate > 0.0:
            keep = keep_mask((1, 1, T, T), self.dropout_rate, q.device,
                             generator)
            w = w * (keep.to(w.dtype) / (1.0 - self.dropout_rate))
        return torch.einsum("bhqk,bkhd->bqhd", w, v)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = (self.heads(p, x) for p in (self.query, self.key,
                                              self.value))
        o = self.attend(q, k, v, train, generator)
        return self.out(o.reshape(x.shape))


class FlashSelfAttention(SelfAttention):
    """The same parameters over `flash_causal_mha`: causality comes from
    the kernel, no mask tensor is built. `p_dtype` is the operand dtype of
    the post-softmax products ('bfloat16' under 'flash16')."""

    def __init__(self, num_heads: int, d_model: int, dtype, param_dtype,
                 p_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_heads, d_model, dtype, param_dtype,
                         generator=generator)
        self.p_dtype = p_dtype

    def attend(self, q, k, v, train: bool, generator):
        return flash_causal_mha(q, k, v, p_dtype=self.p_dtype)

    def decode(self, h, k_cache, v_cache, pos):
        """One KV-cache attention step with a position per row, in plain
        tensor code. h (B, 1, d) is this step's (already normalized) token
        per stream; k_cache, v_cache (B, S, H, Dh) hold each stream's keys
        and values and are written in place; pos (B,) is where row b's new
        key and value land. Attention covers indices <= pos[b], so stale
        entries beyond a reset row's position are never read. flax MHA's
        numerics, as SelfAttention.attend. Returns (out (B, 1, d), k_cache,
        v_cache)."""
        q = self.heads(self.query, h)            # (B, 1, H, Dh)
        rows = torch.arange(h.shape[0], device=h.device)
        k_cache[rows, pos] = self.heads(self.key, h)[:, 0].to(k_cache.dtype)
        v_cache[rows, pos] = self.heads(self.value, h)[:, 0].to(v_cache.dtype)
        dh = q.shape[-1]
        q = q / _sqrt_in(q.dtype, dh)
        scores = torch.einsum("bqhd,bshd->bhqs", q, k_cache.to(q.dtype))
        valid = torch.arange(k_cache.shape[1],
                             device=h.device)[None, :] <= pos[:, None]
        scores = scores.masked_fill(~valid[:, None, None, :],
                                    torch.finfo(scores.dtype).min)
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqs,bshd->bqhd", w, v_cache.to(q.dtype))
        return self.out(o.reshape(h.shape)), k_cache, v_cache


class RingSelfAttention(SelfAttention):
    """Context-parallel causal self-attention over `SelfAttention`'s
    parameters: q, k and v are this rank's (B, T_loc, H, Dh) shard and
    attention sweeps the ring of the current mesh's `cp_axis`
    (`ring_util.current_mesh`); `zigzag` takes the balanced schedule."""

    def __init__(self, num_heads: int, d_model: int, dtype, param_dtype,
                 cp_axis: str = "ctx", zigzag: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_heads, d_model, dtype, param_dtype,
                         generator=generator)
        self.cp_axis, self.zigzag = cp_axis, zigzag

    def attend(self, q, k, v, train: bool, generator):
        mha = zigzag_causal_mha if self.zigzag else ring_causal_mha
        return mha(q, k, v, mesh=cp_mesh(self.cp_axis, "attention"),
                   axis_name=self.cp_axis)


def cp_mesh(axis: str, what: str):
    """The mesh of the enclosing `ring_util.axis_env`, or a ValueError
    naming the context-parallel entry points."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(
            f"ar.attn_impl ring|zigzag ({what}) must be applied inside "
            f"ring_util.axis_env(mesh) with mesh axis {axis!r} (z sharded "
            f"along T): use cpc_tpu_torch.parallel.cp; a plain forward has "
            f"no {axis!r} axis")
    return mesh


class _Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int,
                 dropout_rate: float, dtype, param_dtype,
                 attn_impl: str = "xla",
                 generator: Optional[torch.Generator] = None,
                 cp_axis: str = "ctx"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ln_attn = _LayerNorm(d_model, dtype, param_dtype)
        if attn_impl in ("ring", "zigzag"):
            self.attn = RingSelfAttention(
                num_heads, d_model, dtype, param_dtype, cp_axis=cp_axis,
                zigzag=attn_impl == "zigzag", generator=generator)
        elif attn_impl in ("flash", "flash16"):
            self.attn = FlashSelfAttention(
                num_heads, d_model, dtype, param_dtype,
                p_dtype="bfloat16" if attn_impl == "flash16" else "float32",
                generator=generator)
        else:
            self.attn = SelfAttention(num_heads, d_model, dtype, param_dtype,
                                      dropout_rate=dropout_rate,
                                      generator=generator)
        self.ln_mlp = _LayerNorm(d_model, dtype, param_dtype)
        self.fc1 = Dense(d_model, d_model * mlp_ratio, dtype, param_dtype,
                         generator)
        self.fc2 = Dense(d_model * mlp_ratio, d_model, dtype, param_dtype,
                         generator)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.ln_mlp(x)), approximate="tanh"))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.attn(self.ln_attn(x), train, generator)
        x = x + dropout(h, self.dropout_rate, train, generator)
        return x + dropout(self.mlp(x), self.dropout_rate, train, generator)

    def decode_step(self, x, k_cache, v_cache, pos):
        """Incremental twin of forward for one token per stream. Needs the
        attention module that has `decode` (attn_impl != 'xla': see
        carry_decode_model). Returns (x', k_cache, v_cache)."""
        if not isinstance(self.attn, FlashSelfAttention):
            raise ValueError(
                "decode_step needs the explicit-projection attention "
                "module; this block was built with attn_impl='xla': wrap "
                "the config via carry_decode_model(), which has the same "
                "parameters")
        a, k_cache, v_cache = self.attn.decode(self.ln_attn(x), k_cache,
                                               v_cache, pos)
        x = x + a
        return x + self.mlp(x), k_cache, v_cache


class CausalTransformer(nn.Module):
    """z (B, T, D) -> c (B, T, d_ar); strictly causal (c_t sees z_<=t)."""

    def __init__(self, input_size: int, config: ArConfig,
                 dtype=torch.float32, param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        if cfg.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"ar.attn_impl must be 'xla'|'flash'|'flash16'|'ring'|"
                f"'zigzag', got {cfg.attn_impl!r}")
        if cfg.attn_impl != "xla" and cfg.dropout > 0:
            raise ValueError(
                f"ar.attn_impl={cfg.attn_impl!r} does not implement "
                "attention-weight dropout (flax's MHA semantics); use "
                "attn_impl='xla' with dropout, or dropout=0.0 with flash")
        self.config = cfg
        self.dtype = dtype
        self.in_proj = Dense(input_size, cfg.d_ar, dtype, param_dtype,
                             generator)
        self.pos_embed = nn.Parameter(torch.empty(
            cfg.max_len, cfg.d_ar, dtype=param_dtype).normal_(
                0.0, 0.02, generator=generator))
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", _Block(
                cfg.d_ar, cfg.num_heads, cfg.mlp_ratio, cfg.dropout, dtype,
                param_dtype, cfg.attn_impl, generator, cfg.cp_axis))
        self.final_norm = _LayerNorm(cfg.d_ar, dtype, param_dtype)

    def blocks(self):
        return [getattr(self, f"block{i}")
                for i in range(self.config.num_layers)]

    def forward(self, z: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        T = z.shape[1]
        if cfg.attn_impl in ("ring", "zigzag"):
            # z is this rank's time shard: positions are globally offset
            ring = cp_mesh(cfg.cp_axis, "the transformer").ring(cfg.cp_axis)
            if ring.size * T > cfg.max_len:
                raise ValueError(f"global sequence {ring.size}*{T} > "
                                 f"max_len {cfg.max_len}")
            pos = self.pos_embed[ring.index * T:(ring.index + 1) * T]
        else:
            if T > cfg.max_len:
                raise ValueError(f"sequence length {T} > max_len "
                                 f"{cfg.max_len}")
            pos = self.pos_embed[:T]
        x = self.in_proj(z) + pos.to(self.dtype)[None]
        x = dropout(x, cfg.dropout, train, generator)
        live = train and cfg.dropout > 0
        for blk in self.blocks():
            if cfg.remat:
                # ar.remat: only the (B, T, d_ar) residual stream stays live
                # across the forward; the recompute starts the generator
                # where the forward found it, so the draws are the same
                state = generator.get_state() if live else None
                x = checkpoint(_run_block, blk, x, train, generator, state,
                               use_reentrant=False)
            else:
                x = blk(x, train, generator)
        return self.final_norm(x)

    def decode_step(self, z_t: torch.Tensor, carry: Dict):
        """One incremental step with the KV cache as an explicit carry:
        z_t (B, D_enc) -> (c_t (B, d_ar), carry'). carry is decode_carry()'s
        dict, or the same with k and v stacked (L, B, S, H, Dh). Each batch
        row advances or restarts on its own (reset row b with pos[b] = 0).
        c_t equals column pos[b] of the offline forward over that stream's
        tokens so far. The caller bounds each row's position by
        cfg.max_len: past the table the index is out of range."""
        k_all, v_all, pos = carry["k"], carry["v"], carry["pos"]
        x = self.in_proj(z_t)[:, None, :]                      # (B, 1, d)
        x = x + self.pos_embed[pos].to(self.dtype)[:, None, :]
        for i, blk in enumerate(self.blocks()):
            # k_all[i] is a layer's buffer in both carry forms (an entry of
            # the tuple, or a view of the stacked tensor), written in place
            x, _, _ = blk.decode_step(x, k_all[i], v_all[i], pos)
        c_t = self.final_norm(x)[:, 0]
        return c_t, {"k": k_all, "v": v_all, "pos": pos + 1}


def _run_block(blk: _Block, x, train, generator, state):
    if state is not None:
        generator.set_state(state)
    return blk(x, train, generator)


def decode_carry(cfg: ArConfig, n_streams: int, device=None) -> Dict:
    """Fresh cache-as-carry for decode_step: per-layer K/V buffers as a
    num_layers-tuple of (n_streams, max_len, num_heads, head_dim) fp32
    zeros, plus per-stream positions (n_streams,) int64 zeros."""
    dh = cfg.d_ar // cfg.num_heads
    shape = (n_streams, cfg.max_len, cfg.num_heads, dh)

    def buffers():
        return tuple(torch.zeros(shape, dtype=torch.float32, device=device)
                     for _ in range(cfg.num_layers))
    return {"k": buffers(), "v": buffers(),
            "pos": torch.zeros((n_streams,), dtype=torch.int64,
                               device=device)}


def carry_decode_model(input_size: int, cfg: ArConfig) -> CausalTransformer:
    """The fp32 decode twin: the same parameters as every attn_impl, built
    on the attention module decode_step needs. The flash kernels never run
    on the decode path: decode_step is plain tensor code."""
    ar = dataclasses.replace(cfg, attn_impl="flash", dropout=0.0)
    return CausalTransformer(input_size, ar, dtype=torch.float32,
                             param_dtype=torch.float32)
