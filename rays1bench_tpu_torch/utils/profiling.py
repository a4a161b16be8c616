"""Tracing and profiling hooks on torch.profiler
(rays1bench_tpu/utils/profiling.py, there on jax.profiler).

* `trace(logdir)`: a context manager that profiles the block, host ops
  and, where this torch build traces a card, its CUDA kernels, and writes
  a Chrome trace into logdir (<host>_<pid>.pt.trace.json: Perfetto or
  chrome://tracing, and TensorBoard's PyTorch profiler plugin, read it);
* `annotate(name)`: a named host span (record_function) in that trace;
* `device_memory_stats(device)`: torch.cuda.memory_stats of a CUDA device
  (bytes in use, peaks), None on the CPU, as the JAX version returns None
  where the backend keeps no stats.
"""

from __future__ import annotations

import contextlib
import glob
import os
import socket
from typing import Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity

TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block into logdir; yields the running profiler. Device
    activity is traced where torch.profiler supports CUDA."""
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}{TRACE_SUFFIX}"))


def trace_files(logdir: str) -> List[str]:
    """The traces trace() wrote into logdir, sorted."""
    return sorted(glob.glob(os.path.join(logdir, f"*{TRACE_SUFFIX}")))


def annotate(name: str):
    """Named host-side span that shows up in profiler traces."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> Optional[dict]:
    """torch.cuda.memory_stats of `device` (default: the current CUDA
    device when torch sees one), or None for a CPU device."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device)
