"""The traced run's readings from torch.profiler: device busy time, each
kernel's device time and launches, the device operations that took most
time, and the longest idle gaps with what the host was doing in them.

busy_us is a copy of the program's bench/profile.busy_us: the device's busy
time is the union of its events, so overlapping events count once.
"""

from __future__ import annotations

import collections
import re
import time

TOP = 10
NAME_CHARS = 80


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_kernel(event_name: str, function: str) -> bool:
    """A device event is a launch of the __global__ `function` (a plain
    name, a namespaced one or a template instance)."""
    return re.search(rf"(^|::|\s){re.escape(function)}[(<]", event_name) \
        is not None or event_name == function


def idle_gaps(device, host, top=TOP) -> list:
    """The `top` longest gaps between merged device intervals, each named
    by the innermost host operation running at the gap's middle ("no host
    op" where none). device, host: [(start_us, end_us)] and [(name,
    start_us, end_us)]. Returns [[name, seconds], ...], longest first."""
    m = merged(device)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(m, m[1:])),
                  reverse=True)[:top]
    out = []
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        inside = [h for h in host if h[1] <= mid <= h[2]]
        name = max(inside, key=lambda h: h[1])[0] if inside else "no host op"
        out.append([name[:NAME_CHARS], length / 1e6])
    return out


def is_collective(event_name: str) -> bool:
    """A device event of NCCL: its kernels, which spin on the card while a
    rank waits for the others, and its annotations ("nccl:all_reduce")."""
    return event_name.lower().startswith("nccl")


def summarize(device_events, host_events, window_s) -> dict:
    """device_events: [(name, start_us, end_us)] of the device; host_events
    the same of the host's operations. Returns {"busy_s", "compute_s" (busy
    but for the collectives), "window_s", "ops": {name: [seconds,
    launches]}, "device_ops": [[name, s]], "idle_gaps": [[name, s]]}, names
    in "ops" whole."""
    busy = busy_us((s, e) for _, s, e in device_events) / 1e6
    compute = busy_us((s, e) for n, s, e in device_events
                      if not is_collective(n)) / 1e6
    ops = collections.defaultdict(lambda: [0.0, 0])
    for n, s, e in device_events:
        ops[n][0] += (e - s) / 1e6
        ops[n][1] += 1
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"busy_s": busy, "compute_s": compute, "window_s": window_s,
            "ops": dict(ops),
            "device_ops": [[n[:NAME_CHARS], v[0]] for n, v in top],
            "idle_gaps": idle_gaps([(s, e) for _, s, e in device_events],
                                   host_events)}


def kernel_time(summary: dict, function: str) -> tuple:
    """(device seconds, launches) of the __global__ `function` in a
    summary; (0.0, 0) where it never ran."""
    s, n = 0.0, 0
    for name, (sec, count) in summary["ops"].items():
        if is_kernel(name, function):
            s, n = s + sec, n + count
    return s, n


class Window:
    """A measured window. Use as a context manager and call tick() after
    each frame or step; .seconds is the window's host-clock length and
    .units the frames or steps in it. When traced, torch.profiler records
    the window's first `trace_seconds` (whole frames or steps: it stops at
    the first tick past them, after a synchronisation), so that reading the
    trace stays short; .summary() then reads that slice."""

    def __init__(self, traced: bool, sync, trace_seconds: float):
        self.traced, self.sync, self.trace_seconds = traced, sync, \
            trace_seconds
        self.prof, self.seconds, self.units = None, None, 0
        self.traced_s = self.traced_units = None

    def __enter__(self):
        if self.traced:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.sync()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def tick(self):
        self.units += 1
        if self.traced_s is None and self.prof is not None \
                and self.elapsed() >= self.trace_seconds:
            self._stop_trace()

    def _stop_trace(self):
        self.sync()
        self.traced_s, self.traced_units = self.elapsed(), self.units
        self.prof.__exit__(None, None, None)

    def __exit__(self, *exc):
        self.sync()
        self.seconds = self.elapsed()
        if self.prof is not None and self.traced_s is None:
            self._stop_trace()
        return False

    def events(self):
        import torch
        device, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.events():
            row = (e.name, e.time_range.start, e.time_range.end)
            (device if e.device_type == cuda else host).append(row)
        return device, host

    def summary(self):
        """summarize() of the traced slice, with "units", the frames or
        steps in it; None when not traced."""
        if self.prof is None:
            return None
        return dict(summarize(*self.events(), self.traced_s),
                    units=self.traced_units)

