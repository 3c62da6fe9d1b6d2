"""Feature extraction: run the frozen encoder and gar over long audio in
sliding windows and return the (z, c) trajectories.

Port of `cpc_tpu/eval/features.py::extract_features`. Windows run in
fixed-size batches on the device the model's params are on, under
`torch.inference_mode()`; the window count is padded to a multiple of
`batch_windows` with zero windows and the tail is trimmed; an fp32 model
runs with TF32 off (`utils.precision.exact_for`). Overlapping
windows (hop < window) stitch one continuous trajectory: every window
contributes the latents of its final `hop` samples (the first window
contributes everything), so each latent appears exactly once and the gar
context entering each kept segment is warmed by the `window - hop` overlap.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cpc_tpu_torch.models.cpc import CPCModel
from cpc_tpu_torch.ops.dsp import prepare_waveform
from cpc_tpu_torch.utils.precision import exact_for


def extract_features(
    model: CPCModel,
    waveform: np.ndarray,
    *,
    window: int = 20_480,
    hop: Optional[int] = None,
    batch_windows: int = 32,
    normalize: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """waveform (T,) float32 -> (z (N, d_enc), c (N, d_ar)) float32 numpy
    trajectories, N = T // (samples per latent)."""
    hop = window if hop is None else hop
    if not 0 < hop <= window:
        raise ValueError(f"need 0 < hop <= window, got hop={hop}")
    T = len(waveform)
    n_win = max(1, 1 + (max(T - window, 0) + hop - 1) // hop)
    pad_len = (n_win - 1) * hop + window
    x = np.zeros(pad_len, dtype=np.float32)
    x[:T] = waveform
    starts = np.arange(n_win) * hop
    wins = np.stack([x[s:s + window] for s in starts])  # (n_win, window)

    # pad the window count to a multiple of batch_windows: one batch shape
    n_pad = (-n_win) % batch_windows
    if n_pad:
        wins = np.concatenate([wins, np.zeros((n_pad, window), np.float32)])

    device = next(model.parameters()).device
    zs, cs = [], []
    with torch.inference_mode(), exact_for(model.dtype):
        for i in range(0, len(wins), batch_windows):
            batch = torch.from_numpy(wins[i:i + batch_windows]).to(device)
            z, c = model.latents(prepare_waveform(batch, normalize=normalize))
            zs.append(z.float().cpu().numpy())
            cs.append(c.float().cpu().numpy())
    z_w = np.concatenate(zs)[:n_win]  # (n_win, T_lat, d_enc)
    c_w = np.concatenate(cs)[:n_win]
    t_lat = z_w.shape[1]
    ds = window // t_lat  # samples per latent (160x contract)

    if hop == window:
        z = z_w.reshape(-1, z_w.shape[-1])
        c = c_w.reshape(-1, c_w.shape[-1])
    else:
        if hop % ds or window % ds:
            raise ValueError(
                f"hop and window must be multiples of the {ds}x downsample "
                f"factor for seamless stitching (got hop={hop}, "
                f"window={window})")
        keep = hop // ds          # latents each overlapped window contributes
        lead = t_lat - keep       # warm-context latents to drop
        z = np.concatenate([z_w[0], z_w[1:, lead:].reshape(-1, z_w.shape[-1])])
        c = np.concatenate([c_w[0], c_w[1:, lead:].reshape(-1, c_w.shape[-1])])

    # trim latents that came from the zero-padded tail
    n_valid = T // ds
    return z[:n_valid], c[:n_valid]
