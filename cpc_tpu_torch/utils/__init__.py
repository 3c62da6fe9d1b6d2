"""Tools around the PyTorch port's training: step timing, profiler traces
and nan-debug (`profiling`)."""
