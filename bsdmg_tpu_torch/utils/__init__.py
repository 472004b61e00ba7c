"""Utilities of the port: ``profiling`` (torch.profiler traces, FP32
operation counts of the kernels, speed-of-light estimates on an H100)."""
