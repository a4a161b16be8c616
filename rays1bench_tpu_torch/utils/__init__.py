"""Benchmark metrics (metrics.py) and profiling hooks on torch.profiler
(profiling.py)."""
