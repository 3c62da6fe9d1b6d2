"""Evaluation of the PyTorch port: windowed feature extraction, the linear
probes and their battery, streaming extraction, and their CLI
(`python -m cpc_tpu_torch.eval --battery | --probe ... | --extract ...`)."""

from cpc_tpu_torch.eval.features import extract_features  # noqa: F401
