"""Tools around the PyTorch port's training: step timing, profiler traces
and nan-debug (`profiling`), and fp32 without TF32 on the card
(`precision`)."""
