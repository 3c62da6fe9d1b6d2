"""What a run feeds both sides, made from its seed: the weights, in a few
large draws on the device, and the int16 corpus of snippets.

The weights are float32 (the program keeps float32 masters and computes in
its configuration's dtype): one normal draw for every random leaf, split
and scaled by each leaf's init (`reference.param_specs`). The corpus is
white noise at about a tenth of int16's range, drawn on the device in
blocks of rows. Each draw has a generator of its own, so changing one
input leaves the others as they were.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

_WEIGHTS, _CORPUS = 0x5745, 0x434F  # salts of the two generators
CORPUS_RMS = 3000.0
BLOCK_SAMPLES = 1 << 26


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, salt); any seed up to
    2**64 - 1 - salt."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) + (salt << 48)) % (1 << 64))


def make_weights(specs: Sequence[tuple], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device` for every (name, shape, init) of
    `specs`."""
    random = [(n, s, i) for n, s, i in specs if i[0] == "normal"]
    total = sum(int(np.prod(s)) for _, s, _ in random)
    draw = torch.randn(total, generator=generator(seed, _WEIGHTS, device),
                       device=device)
    out, at = {}, 0
    for name, shape, init in specs:
        if init[0] == "normal":
            n = int(np.prod(shape))
            out[name] = draw[at:at + n].view(shape) * init[1]
            at += n
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out


def make_corpus(n: int, samples: int, seed: int, device) -> torch.Tensor:
    """(n, samples) int16 on `device`."""
    out = torch.empty((n, samples), dtype=torch.int16, device=device)
    g = generator(seed, _CORPUS, device)
    rows = max(1, BLOCK_SAMPLES // samples)
    for a in range(0, n, rows):
        block = torch.randn((min(rows, n - a), samples), generator=g,
                            device=device)
        out[a:a + rows] = (block * CORPUS_RMS).round_().clamp_(
            -32768, 32767).to(torch.int16)
    return out


class ArrayDataset:
    """An in-memory (N, S) int16 corpus as the trainer's Batcher and
    device-corpus upload read a dataset: len and snippet_int16(i)."""

    def __init__(self, corpus: np.ndarray):
        self.corpus = corpus

    def __len__(self) -> int:
        return len(self.corpus)

    def snippet_int16(self, i: int) -> np.ndarray:
        return self.corpus[i]

