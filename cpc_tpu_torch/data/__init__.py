"""Host data for the PyTorch port: WAV I/O, the snippet index, synthetic
corpora (numpy only) and the prefetching Batcher."""
