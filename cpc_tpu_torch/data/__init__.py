"""Host data for the PyTorch port: WAV and FLAC I/O (the FLAC decoder
native, built by g++ at first use), the snippet index, packed corpora,
synthetic corpora (numpy only) and the prefetching Batcher."""
