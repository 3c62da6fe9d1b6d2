"""Weights carried across from the JAX package.

`from_jax_params(params, cfg)` turns `cpc_tpu`'s `params` pytree (nested
dicts of arrays, with or without the outer {"params": ...}) into the
port's `state_dict`. Layout facts it encodes (as `cpc_tpu/interop.py`):

  * flax Conv kernel (k, in, out) -> torch conv weight (out, in, k);
  * flax LayerNorm scale/bias -> weight/bias;
  * GRU wi (D, 3H), wh (H, 3H), bi, bh keep the JAX layout and names;
  * transformer gar: a flax Dense kernel (in, out) -> weight (out, in);
    the attention's DenseGeneral query/key/value kernels (d, H, Dh) and
    biases (H, Dh) flatten to (d, d) and (d,) with feature h*Dh + e, and its
    `out` kernel (H, Dh, d) to (d, d), then transpose likewise; `pos_embed`
    carries over; `block{i}` keeps its name, `LayerNorm_0/1` become
    `ln_attn`/`ln_mlp`, `MultiHeadDotProductAttention_0` `attn`,
    `Dense_0/1` `fc1`/`fc2`;
  * the heads' Dense kernel (d_ar, K*d_enc) -> Linear weight (K*d_enc, d_ar),
    so output feature k*d_enc + e is row e of W_k.

The mapping is a pure re-layout, so it carries a gradient pytree of the
same structure across too (tests/test_torch_port_train_step.py compares
every gradient through it).

A JAX workdir hands its weights over as one `.npz` of the pytree flattened
to '/'-joined keys (`flatten_params`); `unflatten_params` reads it back.
Neither side needs the other framework installed for the file itself.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from cpc_tpu_torch.config import ArConfig, CPCConfig, EncoderConfig


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays -> {'a/b/c': float32 ndarray}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_params(v, key + "/"))
        else:
            flat[key] = np.asarray(v, np.float32)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray]) -> Dict:
    """Inverse of flatten_params (e.g. over an opened `.npz`)."""
    tree: Dict = {}
    for key in flat:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(flat[key])
    return tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def encoder_state_dict(p: Mapping, enc: EncoderConfig) -> Dict[str, torch.Tensor]:
    """flax ConvEncoder params -> ConvEncoder state_dict."""
    sd = {}
    for i in range(len(enc.channels)):
        conv = p[f"conv{i}"]
        sd[f"conv{i}.weight"] = _t(conv["kernel"]).permute(2, 1, 0).contiguous()
        sd[f"conv{i}.bias"] = _t(conv["bias"])
        if enc.norm == "layer":
            sd[f"norm{i}.weight"] = _t(p[f"norm{i}"]["scale"])
            sd[f"norm{i}.bias"] = _t(p[f"norm{i}"]["bias"])
    return sd


def gru_state_dict(p: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """flax GRU params -> GRU state_dict (same layout and names)."""
    return {f"layer{n}.{k}": _t(p[f"layer{n}"][k])
            for n in range(num_layers) for k in ("wi", "bi", "wh", "bh")}


def _dense(p: Mapping, d_in: int) -> Dict[str, torch.Tensor]:
    """A flax Dense or DenseGeneral leaf whose kernel's leading axes hold
    `d_in` input features in all -> {"weight" (out, in), "bias" (out,)}."""
    return {"weight": _t(p["kernel"]).reshape(d_in, -1).T.contiguous(),
            "bias": _t(p["bias"]).reshape(-1)}


def _norm(p: Mapping) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def transformer_state_dict(p: Mapping, ar: ArConfig,
                           d_in: int) -> Dict[str, torch.Tensor]:
    """flax CausalTransformer params -> CausalTransformer state_dict."""
    d = ar.d_ar
    tree = {"in_proj": _dense(p["in_proj"], d_in),
            "final_norm": _norm(p["final_norm"])}
    for i in range(ar.num_layers):
        blk = p[f"block{i}"]
        mha = blk["MultiHeadDotProductAttention_0"]
        tree[f"block{i}"] = {
            "ln_attn": _norm(blk["LayerNorm_0"]),
            "attn": {name: _dense(mha[name], d)
                     for name in ("query", "key", "value", "out")},
            "ln_mlp": _norm(blk["LayerNorm_1"]),
            "fc1": _dense(blk["Dense_0"], d),
            "fc2": _dense(blk["Dense_1"], d * ar.mlp_ratio)}
    sd = {"pos_embed": _t(p["pos_embed"])}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                sd[prefix + k] = v
    walk(tree, "")
    return sd


def from_jax_params(params: Mapping, cfg: CPCConfig) -> Dict[str, torch.Tensor]:
    """cpc_tpu CPCModel params -> state_dict of cpc_tpu_torch's CPCModel.
    Load it with `model.load_state_dict(sd)` (strict: a tree that does not
    match the config raises there)."""
    mc = cfg.model
    if mc.encoder.kind != "conv1d":
        raise NotImplementedError(
            "the port covers the conv1d encoder only (ROADMAP.md §A12); got "
            f"encoder={mc.encoder.kind!r}")
    p = params.get("params", params)
    sd = {f"encoder.{k}": v
          for k, v in encoder_state_dict(p["encoder"], mc.encoder).items()}
    if mc.ar.kind == "transformer":
        gar = transformer_state_dict(p["gar"], mc.ar, mc.encoder.channels[-1])
    else:
        gar = gru_state_dict(p["gar"], mc.ar.num_layers)
    sd.update({f"gar.{k}": v for k, v in gar.items()})
    sd["prediction_heads.weight"] = _t(
        p["prediction_heads"]["kernel"]).T.contiguous()
    return sd
