"""Ops of the PyTorch port: waveform preparation, InfoNCE, and the CUDA
kernels (GRU recurrence, fused heads + InfoNCE) with their plain PyTorch
versions."""
