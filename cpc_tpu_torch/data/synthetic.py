"""Synthetic corpora: a numpy copy of `cpc_tpu/data/synthetic.py`.

Three layouts:
  * LibriSpeech-style speech: `<root>/<speaker>/<chapter>/<utt>.wav` with
    per-speaker harmonic profiles and phone-like segments, and a sibling
    `<utt>.phones.npy` of per-sample phone labels;
  * `dynamics` speech: the same layout, but a speaker differs from another
    only in its phone-transition Markov dynamics (every speaker's
    stationary distribution is uniform and the voice is shared), so the
    speaker probe measures learned temporal structure;
  * MAESTRO-style music: `<root>/<year>/<piece>.wav` of random note
    sequences with piano-like envelopes.
The same seed gives byte-identical files from both packages
(tests/test_torch_port_data.py, tests/test_torch_port_feed.py).
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from cpc_tpu_torch.data.wavio import write_wav

# Five synthetic "phones": formant-frequency pairs (F1, F2) in Hz, roughly
# vowel-like so phone identity is linearly decodable from spectra.
_PHONES = [
    (730.0, 1090.0),   # aa
    (270.0, 2290.0),   # iy
    (300.0, 870.0),    # uw
    (530.0, 1840.0),   # eh
    (640.0, 1190.0),   # ah
]

NUM_PHONES = len(_PHONES)


def _speech_utterance(rng: np.random.Generator, n_samples: int, sr: int,
                      f0: float, formant_scale: float):
    """Returns (waveform, phone label per sample)."""
    seg_len = int(0.12 * sr)  # ~120 ms phone segments
    n_segs = n_samples // seg_len + 2
    phone_ids = rng.integers(0, NUM_PHONES, n_segs)
    labels = np.repeat(phone_ids, seg_len)[:n_samples].astype(np.int32)
    return _synth_from_labels(rng, labels, sr, f0, formant_scale), labels


def _synth_from_labels(rng: np.random.Generator, labels: np.ndarray,
                       sr: int, f0: float, formant_scale: float):
    n_samples = len(labels)
    t = np.arange(n_samples) / sr
    # glottal-ish source: harmonic stack at speaker f0 with jitter
    f0_track = f0 * (1.0 + 0.02 * np.cumsum(rng.standard_normal(n_samples))
                     / np.sqrt(np.arange(1, n_samples + 1)))
    phase = 2 * np.pi * np.cumsum(f0_track) / sr
    wave = np.zeros(n_samples)
    for h in range(1, 9):
        wave += np.sin(h * phase) / h
    # phone-dependent formant emphasis: add sinusoids at the formants
    for p, (f1, f2) in enumerate(_PHONES):
        mask = labels == p
        if not mask.any():
            continue
        tt = t[mask]
        wave[mask] += 0.8 * np.sin(2 * np.pi * f1 * formant_scale * tt)
        wave[mask] += 0.5 * np.sin(2 * np.pi * f2 * formant_scale * tt)
    wave += 0.02 * rng.standard_normal(n_samples)
    wave *= 0.2 / (np.abs(wave).max() + 1e-9)
    return wave.astype(np.float32)


def speaker_transition_matrices(num_speakers: int, rng: np.random.Generator,
                                alpha: float = 0.75) -> np.ndarray:
    """(num_speakers, P, P) Markov transition matrices, one per speaker,
    each `alpha * permutation + (1-alpha) * uniform`.

    Every matrix is doubly stochastic, so the stationary distribution over
    phones is UNIFORM for every speaker: time-pooled phone statistics (and
    hence pooled frame spectra, in expectation) carry no speaker identity —
    only the transition *dynamics* do. Distinct DERANGEMENTS (permutations
    without fixed points — a fixed point is a self-transition, which merely
    extends a segment and carries no observable transition signal) keep
    speakers well separated; 5 phones give 44 of them."""
    import itertools
    perms = [p for p in itertools.permutations(range(NUM_PHONES))
             if all(i != j for i, j in enumerate(p))]
    if num_speakers > len(perms):
        raise ValueError(
            f"at most {len(perms)} dynamics speakers with {NUM_PHONES} phones")
    chosen = rng.permutation(len(perms))[:num_speakers]
    mats = np.empty((num_speakers, NUM_PHONES, NUM_PHONES))
    for s, ci in enumerate(chosen):
        pm = np.zeros((NUM_PHONES, NUM_PHONES))
        for i, j in enumerate(perms[ci]):
            pm[i, j] = 1.0
        mats[s] = alpha * pm + (1.0 - alpha) / NUM_PHONES
    return mats


def _dynamics_labels(rng: np.random.Generator, n_samples: int, sr: int,
                     trans: np.ndarray) -> np.ndarray:
    """Phone labels sampled from the Markov chain `trans` with ~90-150 ms
    segments (length jitter shared across speakers)."""
    labels = np.empty(n_samples, np.int32)
    state = int(rng.integers(0, NUM_PHONES))
    pos = 0
    while pos < n_samples:
        seg = int(sr * rng.uniform(0.09, 0.15))
        labels[pos:pos + seg] = state
        pos += seg
        state = int(rng.choice(NUM_PHONES, p=trans[state]))
    return labels


def generate_synthetic_corpus(
    root: str,
    *,
    style: str = "speech",
    num_speakers: int = 8,
    files_per_speaker: int = 3,
    seconds_per_file: float = 4.0,
    sample_rate: int = 16_000,
    seed: int = 0,
    write_labels: bool = True,
) -> List[str]:
    """Generates the corpus; returns the list of wav paths. For speech style,
    a sibling `<utt>.phones.npy` per-sample phone-label file is written when
    `write_labels` (consumed by the phone probe)."""
    rng = np.random.default_rng(seed)
    n_samples = int(seconds_per_file * sample_rate)
    paths = []
    os.makedirs(root, exist_ok=True)
    if style == "speech":
        meta = {}
        for spk in range(num_speakers):
            f0 = float(rng.uniform(80, 260))
            fs = float(rng.uniform(0.85, 1.2))
            meta[str(spk)] = {"f0": f0, "formant_scale": fs}
            d = os.path.join(root, f"{spk}", "0")
            os.makedirs(d, exist_ok=True)
            for utt in range(files_per_speaker):
                wave, labels = _speech_utterance(rng, n_samples, sample_rate,
                                                 f0, fs)
                p = os.path.join(d, f"{spk}-0-{utt:04d}.wav")
                write_wav(p, wave, sample_rate)
                if write_labels:
                    np.save(p.replace(".wav", ".phones.npy"), labels)
                paths.append(p)
        with open(os.path.join(root, "speakers.json"), "w") as f:
            json.dump(meta, f)
    elif style == "dynamics":
        # Speaker identity lives ONLY in phone-transition dynamics: all
        # speakers share the phone inventory and the f0/formant distribution
        # (drawn per UTTERANCE), and every transition matrix has a uniform
        # stationary distribution (speaker_transition_matrices docstring).
        # A linear probe on time-pooled features of a random encoder sits
        # near chance here; only a context representation that has learned
        # the per-speaker transition structure separates speakers — which is
        # exactly what CPC pretraining is supposed to produce.
        mats = speaker_transition_matrices(num_speakers, rng)
        meta = {}
        for spk in range(num_speakers):
            meta[str(spk)] = {"transition": mats[spk].round(4).tolist()}
            d = os.path.join(root, f"{spk}", "0")
            os.makedirs(d, exist_ok=True)
            for utt in range(files_per_speaker):
                f0 = float(rng.uniform(100, 220))  # shared dist, per-utt
                labels = _dynamics_labels(rng, n_samples, sample_rate,
                                          mats[spk])
                wave = _synth_from_labels(rng, labels, sample_rate, f0, 1.0)
                p = os.path.join(d, f"{spk}-0-{utt:04d}.wav")
                write_wav(p, wave, sample_rate)
                if write_labels:
                    np.save(p.replace(".wav", ".phones.npy"), labels)
                paths.append(p)
        with open(os.path.join(root, "speakers.json"), "w") as f:
            json.dump(meta, f)
    elif style == "music":
        for piece in range(num_speakers * files_per_speaker):
            d = os.path.join(root, "2019")
            os.makedirs(d, exist_ok=True)
            wave = _music_piece(rng, n_samples, sample_rate)
            p = os.path.join(d, f"piece_{piece:04d}.wav")
            write_wav(p, wave, sample_rate)
            paths.append(p)
    else:
        raise ValueError(f"unknown style {style!r}")
    return paths


def _music_piece(rng: np.random.Generator, n_samples: int, sr: int):
    wave = np.zeros(n_samples, dtype=np.float64)
    t_note = int(0.25 * sr)
    midi = rng.integers(48, 84, n_samples // t_note + 1)
    for i, m in enumerate(midi):
        f = 440.0 * 2 ** ((m - 69) / 12)
        start = i * t_note
        end = min(start + t_note, n_samples)
        tt = np.arange(end - start) / sr
        env = np.exp(-tt * 6.0)
        for h, a in ((1, 1.0), (2, 0.5), (3, 0.3), (4, 0.15)):
            wave[start:end] += a * env * np.sin(2 * np.pi * h * f * tt)
    wave *= 0.2 / (np.abs(wave).max() + 1e-9)
    return wave.astype(np.float32)
