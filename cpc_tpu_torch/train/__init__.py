"""Training of the PyTorch port: step, optimizer, trainer, checkpoints,
metrics, the supervisor and the `python -m cpc_tpu_torch.train` CLI."""
