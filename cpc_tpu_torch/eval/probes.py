"""Frozen-encoder downstream probes: speaker-ID and phone classification
with a linear classifier on frozen CPC features.

Port of `cpc_tpu/eval/probes.py`, every function with its argument names,
defaults and errors. As in the port's `extract_features`, the model carries
its own weights, so the JAX functions' `params` argument is gone.

Protocol (CPC paper §3.1 / the reference's eval):
  * features = context c (default) or latents z, time-pooled per snippet
    for speaker-ID, per frame for phones;
  * a single linear layer trained with softmax cross-entropy and
    full-batch Adam; the CPC model stays frozen (only the probe's weights
    are optimized);
  * top-1 accuracy on a held-out split.

Feature extraction runs the model on its device under
`torch.inference_mode()`. The fit runs on `device` (the model's device for
the `run_*` functions; "cuda" by default for the functions that take
features, where torch raises if there is no card) with optax's Adam
numerics (`train.train_step.Optimizer`). Its initial weights are drawn from a
`torch.Generator` seeded with `seed`; the JAX probe draws them from
`jax.random`, which cannot be matched, so the two packages agree on a
probe's accuracy within a band, not to the bit
(tests/test_torch_port_probes.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cpc_tpu_torch.config import TrainConfig
from cpc_tpu_torch.data.dataset import ProbeDataset
from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.ops.dsp import prepare_waveform
from cpc_tpu_torch.train.train_step import Optimizer
from cpc_tpu_torch.utils.precision import exact_for


@dataclasses.dataclass
class LinearProbeResult:
    accuracy: float
    num_classes: int
    num_train: int
    num_eval: int
    feature: str


def _model_device(model: CPCModel) -> torch.device:
    return next(model.parameters()).device


def _extract(model: CPCModel, snippets: np.ndarray, feature: str,
             batch: int = 32, normalize: bool = True) -> np.ndarray:
    """snippets (N, S) -> per-frame features (N, T, d) float32, in batches
    of `batch` padded with zero snippets.

    Inputs go through the same prepare_waveform (dequantization and
    per-snippet normalization) the training step applies on the device, so
    frozen features come from the distribution the model was trained on;
    an fp32 model runs with TF32 off, as it trained."""
    device = _model_device(model)
    n_pad = (-len(snippets)) % batch
    padded = np.concatenate(
        [snippets, np.zeros((n_pad,) + snippets.shape[1:], snippets.dtype)])
    outs = []
    with torch.inference_mode(), exact_for(model.dtype):
        for i in range(0, len(padded), batch):
            x = torch.from_numpy(padded[i:i + batch]).to(device)
            z, c = model.latents(prepare_waveform(x, normalize=normalize))
            feats = c if feature == "c" else z
            outs.append(feats.float().cpu().numpy())
    return np.concatenate(outs)[:len(snippets)]


def _init_linear(d: int, num_classes: int, seed: int):
    """The probe's initial weights: w0 ~ N(0, 1) * 0.01 (d, num_classes)
    from a torch.Generator seeded with `seed`, and b0 = 0."""
    gen = torch.Generator().manual_seed(seed)
    w0 = torch.randn(d, num_classes, generator=gen) * 0.01
    return w0, torch.zeros(num_classes)


def _fit_linear(x: torch.Tensor, y: torch.Tensor, w0: torch.Tensor,
                b0: torch.Tensor, *, steps: int, lr: float):
    """Full-batch Adam (optax's numerics) on the mean softmax cross-entropy
    of x @ w + b against integer labels y, from (w0, b0), on x's device.
    Returns the final (w, b). The gradient is written out: (softmax - onehot)
    / N through the product's transpose, with no scatter, so that a run on
    the card repeats bit for bit."""
    device = x.device
    params = {"w": w0.to(device, torch.float32).clone(),
              "b": b0.to(device, torch.float32).clone()}
    opt = Optimizer(params, TrainConfig(learning_rate=lr))
    onehot = torch.nn.functional.one_hot(y, params["b"].shape[0]).float()
    n = x.shape[0]
    with torch.no_grad():
        for _ in range(steps):
            logits = x @ params["w"] + params["b"]
            g = (torch.softmax(logits, dim=-1) - onehot) / n
            opt.step({"w": x.T @ g, "b": g.sum(0)})
    return params["w"], params["b"]


def _train_linear(
    x_train: np.ndarray, y_train: np.ndarray,
    x_eval: np.ndarray, y_eval: np.ndarray,
    num_classes: int, *, steps: int = 300, lr: float = 1e-2, seed: int = 0,
    device="cuda",
) -> float:
    """Full-batch Adam on a linear probe; returns eval top-1 accuracy.
    Features are standardized with train-split statistics (numpy, the
    population std + 1e-6)."""
    mu = x_train.mean(axis=0, keepdims=True)
    sd = x_train.std(axis=0, keepdims=True) + 1e-6
    x_train = (x_train - mu) / sd
    x_eval = (x_eval - mu) / sd
    w0, b0 = _init_linear(x_train.shape[-1], num_classes, seed)
    xt = torch.from_numpy(np.ascontiguousarray(x_train, np.float32)).to(device)
    yt = torch.from_numpy(np.asarray(y_train, np.int64)).to(device)
    w, b = _fit_linear(xt, yt, w0, b0, steps=steps, lr=lr)
    xe = torch.from_numpy(np.ascontiguousarray(x_eval, np.float32)).to(device)
    with torch.no_grad():
        pred = (xe @ w + b).argmax(-1).cpu().numpy()
    return float((pred == y_eval).mean())


def _split(n: int, eval_frac: float, seed: int):
    order = np.random.default_rng(seed).permutation(n)
    n_eval = max(1, int(n * eval_frac))
    return order[n_eval:], order[:n_eval]


def _split_items(n: int, files, split: str, eval_frac: float, seed: int):
    """Train/eval index split over n snippets.

    split='snippet' permutes snippets (snippets of the same source file land
    on BOTH sides — leaks per-recording signatures; see RESULTS.md).
    split='file' holds out whole source files, the honest protocol."""
    if split == "file":
        uniq = sorted(set(files))
        _, ev_f = _split(len(uniq), eval_frac, seed)
        ev_files = {uniq[j] for j in ev_f}
        idx = np.arange(n)
        in_eval = np.asarray([f in ev_files for f in files], bool)
        return idx[~in_eval], idx[in_eval]
    if split == "snippet":
        return _split(n, eval_frac, seed)
    raise ValueError(f"split must be 'snippet'|'file', got {split!r}")


def run_speaker_probe(
    model: CPCModel, dataset: ProbeDataset, *,
    feature: str = "c", max_snippets: int = 512, eval_frac: float = 0.25,
    steps: int = 300, seed: int = 0, normalize: bool = True,
    pool: str = "snippet", split: str = "snippet", time_pool: str = "mean",
) -> LinearProbeResult:
    """Time-pooled features -> speaker id, fitted on the model's device.

    time_pool picks the readout over the snippet's frames (pool_time: mean
    | last | max). pool='snippet' classifies each snippet's pooled feature;
    pool='utterance' averages all of a source file's snippet features first
    (file-disjoint by construction). split='snippet' permutes snippets into
    train/eval, so snippets of one file land on both sides; split='file'
    holds out whole files, the honest speaker-ID protocol."""
    pooled, y, files = extract_speaker_features(
        model, dataset, feature=feature, max_snippets=max_snippets,
        normalize=normalize, time_pool=time_pool)
    return probe_speaker_features(
        pooled, y, files, dataset.num_speakers, eval_frac=eval_frac,
        steps=steps, seed=seed, pool=pool, split=split, feature=feature,
        device=_model_device(model))


def extract_speaker_frame_features(
    model: CPCModel, dataset: ProbeDataset, *,
    feature: str = "c", max_snippets: int = 512, normalize: bool = True,
):
    """One forward sweep -> per-frame (feats (N, T, d), labels (N,),
    source files (N,)). Callers wanting several time poolings pool this
    once-extracted array instead of sweeping twice."""
    n = min(len(dataset), max_snippets)
    snippets, labels = [], []
    for i in range(n):
        x, spk, _ = dataset.item_with_labels(i)
        snippets.append(x)
        labels.append(spk)
    feats = _extract(model, np.stack(snippets), feature, normalize=normalize)
    files = [dataset.locate(i)[0] for i in range(n)]
    return feats, np.asarray(labels), files


def pool_time(feats: np.ndarray, time_pool: str) -> np.ndarray:
    """'mean' averages the trajectory; 'last' reads the final frame (where
    a recurrent gar accumulates its evidence); 'max' takes the
    per-dimension maximum over time (the strongest local evidence)."""
    if time_pool == "mean":
        return feats.mean(axis=1)
    if time_pool == "last":
        return feats[:, -1]
    if time_pool == "max":
        return feats.max(axis=1)
    raise ValueError(
        f"time_pool must be 'mean'|'last'|'max', got {time_pool!r}")


def extract_speaker_features(
    model: CPCModel, dataset: ProbeDataset, *,
    feature: str = "c", max_snippets: int = 512, normalize: bool = True,
    time_pool: str = "mean",
):
    """One forward sweep -> (pooled (N, d), labels (N,), source files (N,)).
    Extraction dominates probe cost; callers probing several splits or
    seeds extract once and reuse."""
    feats, labels, files = extract_speaker_frame_features(
        model, dataset, feature=feature, max_snippets=max_snippets,
        normalize=normalize)
    return pool_time(feats, time_pool), labels, files


def probe_speaker_features(
    pooled: np.ndarray, y: np.ndarray, files, num_classes: int, *,
    eval_frac: float = 0.25, steps: int = 300, seed: int = 0,
    pool: str = "snippet", split: str = "snippet", feature: str = "c",
    device="cuda",
) -> LinearProbeResult:
    """Linear speaker probe on pre-extracted pooled features (see
    run_speaker_probe for the pool/split semantics), fitted on `device`."""
    n = len(pooled)
    if pool == "utterance":
        if split not in ("snippet", "file"):
            # utterance pooling is file-disjoint by construction, so either
            # split value is acceptable, but an invalid one still raises
            raise ValueError(f"split must be 'snippet'|'file', got {split!r}")
        groups: dict = {}
        for i in range(n):
            groups.setdefault(files[i], []).append(i)
        idx_groups = list(groups.values())
        pooled = np.stack([pooled[ix].mean(axis=0) for ix in idx_groups])
        y = np.asarray([y[ix[0]] for ix in idx_groups])
        tr, ev = _split(len(pooled), eval_frac, seed)
    elif pool != "snippet":
        raise ValueError(f"pool must be 'snippet'|'utterance', got {pool!r}")
    else:
        tr, ev = _split_items(n, files, split, eval_frac, seed)
    if len(tr) == 0 or len(ev) == 0:
        raise ValueError(
            f"probe split produced {len(tr)} train / {len(ev)} eval items "
            "(too few files/snippets for the requested split)")
    acc = _train_linear(pooled[tr], y[tr], pooled[ev], y[ev],
                        num_classes, steps=steps, seed=seed, device=device)
    return LinearProbeResult(acc, num_classes, len(tr), len(ev), feature)


def extract_phone_frame_features(
    model: CPCModel, dataset: ProbeDataset, *,
    feature: str = "c", max_snippets: int = 256, normalize: bool = True,
):
    """One forward sweep over the phone-labeled snippets -> (feats (N, T, d),
    frame labels (N, T), source files (N,)). Phone labels are per sample;
    each latent frame takes the majority label of its stride (the first
    maximum on ties, as np.bincount(...).argmax() gives)."""
    n = min(len(dataset), max_snippets)
    snippets, frame_labels, files = [], [], []
    for i in range(n):
        x, _, phones = dataset.item_with_labels(i)
        if phones is None:
            continue  # unlabeled snippet (no/partial alignment): skip
        snippets.append(x)
        frame_labels.append(phones)
        files.append(dataset.locate(i)[0])
    if not snippets:
        raise ValueError(
            "phone probe needs <utt>.phones.npy label files "
            "(the synthetic generator writes them; for real corpora dump "
            "forced alignments in the same format)")
    feats = _extract(model, np.stack(snippets), feature,
                     normalize=normalize)  # (N, T, d)
    N, T, _ = feats.shape
    ds = len(snippets[0]) // T
    lab = np.stack(frame_labels)[:, :T * ds].reshape(N, T, ds)
    frame_lab = np.apply_along_axis(
        lambda a: np.bincount(a).argmax(), 2, lab)  # (N, T)
    return feats, frame_lab, files


def probe_phone_features(
    feats: np.ndarray, frame_lab: np.ndarray, files, *,
    num_phones: Optional[int] = None, eval_frac: float = 0.25,
    steps: int = 300, seed: int = 0, split: str = "snippet",
    feature: str = "c", device="cuda",
) -> LinearProbeResult:
    """Frame-level linear phone probe on pre-extracted features, fitted on
    `device`. The split is at snippet granularity (frames of one snippet
    stay together); split='file' also holds out whole source files."""
    N, T, d = feats.shape
    X = feats.reshape(N * T, d)
    y = frame_lab.reshape(N * T)
    n_classes = num_phones or int(y.max()) + 1
    tr, ev = _split_items(N, files, split, eval_frac, seed)
    if len(tr) == 0 or len(ev) == 0:
        raise ValueError(
            f"phone probe split produced {len(tr)} train / {len(ev)} eval "
            "snippets (too few labeled files/snippets for the requested "
            "split)")
    tr_mask = np.zeros(N, bool)
    tr_mask[tr] = True
    tr_idx = np.repeat(tr_mask, T)
    acc = _train_linear(X[tr_idx], y[tr_idx], X[~tr_idx], y[~tr_idx],
                        n_classes, steps=steps, seed=seed, device=device)
    return LinearProbeResult(acc, n_classes, int(tr_idx.sum()),
                             int((~tr_idx).sum()), feature)


def run_phone_probe(
    model: CPCModel, dataset: ProbeDataset, *,
    feature: str = "c", max_snippets: int = 256, eval_frac: float = 0.25,
    steps: int = 300, seed: int = 0, num_phones: Optional[int] = None,
    normalize: bool = True, split: str = "snippet",
) -> LinearProbeResult:
    """Per-frame features -> frame-level phone labels, fitted on the
    model's device. See probe_phone_features for the split semantics."""
    feats, frame_lab, files = extract_phone_frame_features(
        model, dataset, feature=feature, max_snippets=max_snippets,
        normalize=normalize)
    return probe_phone_features(
        feats, frame_lab, files, num_phones=num_phones, eval_frac=eval_frac,
        steps=steps, seed=seed, split=split, feature=feature,
        device=_model_device(model))
