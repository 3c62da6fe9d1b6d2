"""cpc_tpu_torch — the PyTorch / CUDA port of cpc_tpu, for one NVIDIA H100.

It sits beside the JAX package, which stays the reference it is held
against (tests/test_torch_port_*.py), mirrors its module layout and names,
and imports no jax. Ported so far: the feature-extraction path (configs,
waveform prep, the conv1d encoder and the scalogram encoder with its
on-device front end, GRU gar, CPC wrapper, weights from the JAX package,
`extract_features` and its CLI), evaluation and serving (the linear probes
and their battery, `python -m cpc_tpu_torch.eval --battery`; the streaming
extractor and `python -m cpc_tpu_torch.serve`) and training on one card
or data-parallel (every InfoNCE path, optax's Adam, a trainer with exact
resume, `python -m cpc_tpu_torch.train`) fed from WAV, FLAC or packed
corpora at any rate, with on-device augmentation, the device-resident
corpus and the supervisor, with the GRU or the causal transformer as the
context network. Every kernel the JAX package wrote in Pallas has a
hand-written CUDA counterpart (csrc/): the GRU recurrence, the three InfoNCE
paths and the causal flash attention, forward and backward, and the conv
encoder's pyramid, forward (`encoder.use_pallas`).
ROADMAP.md lists what waits.

    import torch
    from cpc_tpu_torch import CPCModel, presets, extract_features
    model = CPCModel(presets.tpu_fast().model, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    z, c = extract_features(model, waveform, batch_windows=64)
"""

from cpc_tpu_torch.config import (  # noqa: F401
    ArConfig,
    CPCConfig,
    DataConfig,
    EncoderConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
    presets,
)
from cpc_tpu_torch.eval.features import extract_features  # noqa: F401
from cpc_tpu_torch.models.cpc import CPCModel, CPCOutput  # noqa: F401
