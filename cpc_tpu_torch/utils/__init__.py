"""Tools around the PyTorch port's training: profiler traces, the
program's host spans and nan-debug (`profiling`), and fp32 without TF32 on
the card (`precision`)."""
