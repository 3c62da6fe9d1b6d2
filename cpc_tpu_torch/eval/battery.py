"""The full probe battery: every readout x split the RESULTS.md studies
report, in one call over ONE feature sweep.

Port of `cpc_tpu/eval/battery.py::probe_milestone`: the same 18 row keys,
the same constants (400 probe steps, the snippet split on the first 800
snippets, the phone probe on z over at most 200 snippets). The snippet
split leaks per-recording signatures, so the headline columns are the
file-disjoint ones; the snippet split stays for the leak's size.

Determinism contract: the probes are seeded and run over cached features,
so the same features give the same row on every call, on the card too (the
fit has no atomics; tests/test_torch_port_probes.py, chip_smoke.py phase
20). Changes here break comparability across runs: add columns, do not
perturb existing ones. The JAX package's rows are not bit-comparable with
these: the probes' initial weights come from another generator.
"""

from __future__ import annotations

import numpy as np

from cpc_tpu_torch.eval.probes import (_model_device,
                                       extract_phone_frame_features,
                                       extract_speaker_frame_features,
                                       pool_time, probe_phone_features,
                                       probe_speaker_features)


def probe_milestone(model, probe_ds, *, normalize: bool,
                    probe_seeds: int = 3) -> dict:
    """One milestone's full probe battery, fitted on the model's device.

    ONE feature sweep, then every split and seed probes the cached
    features. Returns the row dict WITHOUT the "step" key (the caller
    knows the step)."""
    if probe_seeds < 1:
        raise ValueError(f"probe_seeds must be >= 1, got {probe_seeds} "
                         "(0 would silently compute a battery of NaNs "
                         "and then crash after the expensive sweep)")
    device = _model_device(model)
    frames, ylab, files = extract_speaker_frame_features(
        model, probe_ds, max_snippets=len(probe_ds), normalize=normalize)
    pooled = pool_time(frames, "mean")
    last = pool_time(frames, "last")
    mx = pool_time(frames, "max")
    del frames
    n_spk = probe_ds.num_speakers

    def speaker(feats, y, fs, **kw):
        return probe_speaker_features(feats, y, fs, n_spk, steps=400,
                                      device=device, **kw)

    file_accs, last_accs, max_accs, snip_accs = [], [], [], []
    file_eval_ns, snip_eval_ns = [], []
    for ps in range(probe_seeds):
        spk_f = speaker(pooled, ylab, files, seed=ps, split="file")
        file_accs.append(spk_f.accuracy)
        file_eval_ns.append(spk_f.num_eval)
        last_accs.append(speaker(last, ylab, files, seed=ps,
                                 split="file").accuracy)
        max_accs.append(speaker(mx, ylab, files, seed=ps,
                                split="file").accuracy)
        spk_s = speaker(pooled[:800], ylab[:800], files[:800], seed=ps)
        snip_accs.append(spk_s.accuracy)
        snip_eval_ns.append(spk_s.num_eval)
    # utterance pooling collapses a file's snippets into one item, so it
    # uses the WHOLE corpus to keep enough items per class
    utt = speaker(pooled, ylab, files, pool="utterance")
    # the phone probe under both splits (extraction cached across seeds)
    ph_feats, ph_lab, ph_files = extract_phone_frame_features(
        model, probe_ds, feature="z", max_snippets=200, normalize=normalize)
    ph_file_accs = [probe_phone_features(
        ph_feats, ph_lab, ph_files, steps=400, seed=ps, split="file",
        device=device).accuracy for ps in range(probe_seeds)]
    ph = probe_phone_features(ph_feats, ph_lab, ph_files, steps=400,
                              split="snippet", device=device)
    return {"speaker_file_acc": round(float(np.mean(file_accs)), 4),
            "speaker_file_acc_std": round(float(np.std(file_accs)), 4),
            "speaker_file_last_acc": round(float(np.mean(last_accs)), 4),
            "speaker_file_last_acc_std": round(float(np.std(last_accs)), 4),
            "speaker_file_max_acc": round(float(np.mean(max_accs)), 4),
            "speaker_file_max_acc_std": round(float(np.std(max_accs)), 4),
            "speaker_file_eval_n": int(np.mean(file_eval_ns)),
            "speaker_acc": round(float(np.mean(snip_accs)), 4),
            "speaker_acc_std": round(float(np.std(snip_accs)), 4),
            "speaker_eval_n": int(np.mean(snip_eval_ns)),
            "speaker_classes": spk_s.num_classes,
            "speaker_utt_acc": round(utt.accuracy, 4),
            "speaker_utt_eval_n": utt.num_eval,
            "phone_file_acc": round(float(np.mean(ph_file_accs)), 4),
            "phone_file_acc_std": round(float(np.std(ph_file_accs)), 4),
            "phone_snip_acc": round(ph.accuracy, 4),
            "phone_eval_n": ph.num_eval,
            "phone_classes": ph.num_classes}
