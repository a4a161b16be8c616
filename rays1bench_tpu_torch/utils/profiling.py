"""Tracing and profiling on torch.profiler's clock
(rays1bench_tpu/utils/profiling.py, there on jax.profiler).

* `trace(logdir)`: a context manager that profiles the block, host ops
  and, where this torch build traces a card, its CUDA kernels, and writes
  a Chrome trace into logdir (<host>_<pid>.pt.trace.json: Perfetto or
  chrome://tracing, and TensorBoard's PyTorch profiler plugin, read it),
  with the program's spans on a row of their own;
* `span(name, device=False)` and `count(name, value)`: the program's own
  spans and counters, recorded while a torch.profiler session is active;
* `session()`: a torch.profiler session with a store of its own;
* `store`, `spans`, `counts`, `total`, `frame_ms`, `table`, `completed`,
  `interval_ms`: what the recorder holds;
* `busy_us(intervals)`: the length of a union of intervals;
* `device_memory_stats(device)`: torch.cuda.memory_stats of a CUDA device
  (bytes in use, peaks), None on the CPU, as the JAX version returns None
  where the backend keeps no stats.

The recorder is on exactly while a torch.profiler session is active
(torch.autograd._profiler_enabled): the CLI's --profile, trace() and a
benchmark's traced slice. Off, span() and count() cost that flag check,
one attribute write and a shared no-op context: no CUDA event, no
allocation. On, a span records its name, its parent (the span open around
it), the id of its frame (a span opened with none around it starts a new
frame, and every span inside it shares its id), its host start and end in
time.time_ns(), the clock of torch.profiler's trace, and with device=True
two timing CUDA events on the current stream: its stream ms, from the
stream reaching its first op to passing its last, waits for the host's
issue included. A counter keeps its value under the current frame's id as
given: a device tensor stays a tensor until it is read, so no .item() runs
inside a frame, and a function of no arguments is called when it is read. Spans and counters stay in memory; the reads resolve
events and tensors, so call them after the caller has synchronised.

Spans are never record_function ranges: torch.profiler records such a
range that encloses CUDA work as a device event too, which would fill the
device's idle gaps inside it. The recorder adds no synchronisation and no
collective.

A store holds one session's spans and counters. session() and trace()
start a new one when they open. In a session opened otherwise, a span or
counter that finds recording on after one found it off starts a new one,
so two such sessions with no span between them share a store.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import socket
import time
from typing import Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity

TRACE_SUFFIX = ".pt.trace.json"
# The Chrome trace row of the program's spans: a thread id no OS thread
# takes, in the process's own pid.
SPAN_TID = 0x7FFFFFFF
SPAN_ROW = "rays1bench_tpu_torch spans"

_enabled = torch.autograd._profiler_enabled


class Span:
    """One recorded span: name, parent (the enclosing Span or None), frame
    id, host start and end (time.time_ns()) and, for a device span, its
    two CUDA events."""

    __slots__ = ("store", "name", "parent", "frame", "start_ns", "end_ns",
                 "events")

    def __init__(self, store, name, device):
        self.store, self.name = store, name
        self.parent = self.frame = self.start_ns = self.end_ns = None
        self.events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) \
            if device else None

    def __enter__(self):
        store = self.store
        self.parent = store.open[-1] if store.open else None
        if self.parent is None:
            self.frame = store.frames
            store.frames += 1
        else:
            self.frame = self.parent.frame
        store.spans.append(self)
        store.by_frame[self.frame].setdefault(self.name, self)
        store.open.append(self)
        self.start_ns = time.time_ns()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.time_ns()
        self.store.open.remove(self)
        return False

    @property
    def host_ms(self) -> Optional[float]:
        """Host ms from open to close; None while open."""
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def stream_ms(self) -> Optional[float]:
        """Stream ms between the span's two events; None for a host span.
        Both events must have passed (the caller has synchronised)."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])

    def done(self) -> bool:
        """Closed, and its end event passed on the stream: never waits."""
        return self.end_ns is not None and (self.events is None
                                            or self.events[1].query())


class Store:
    """The spans and counters of one profiler session."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts = []          # (frame id or None, name, value)
        self.open: List[Span] = []
        self.by_frame = collections.defaultdict(dict)  # frame -> {name: Span}
        self.frames = 0
        self.handed = -1          # the last frame completed() returned


class _Recorder:
    def __init__(self):
        self.store = Store()
        self.stale = False

    def current(self) -> Store:
        if self.stale:
            self.store, self.stale = Store(), False
        return self.store


_REC = _Recorder()
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether spans and counters are recorded now."""
    return _enabled()


def span(name: str, device: bool = False):
    """A context manager recording a span named `name` (with device=True,
    also on the current CUDA stream) while recording is on; a shared no-op
    otherwise."""
    if not _enabled():
        _REC.stale = True
        return _OFF
    return Span(_REC.current(), name, device)


def count(name: str, value) -> None:
    """Add `value` (a number, a tensor kept as it is until read, or a
    function of no arguments called when read) to the counter `name` of the
    current frame, while recording is on."""
    if not _enabled():
        _REC.stale = True
        return
    store = _REC.current()
    store.counts.append((store.open[-1].frame if store.open else None,
                         name, value))


def store() -> Store:
    """The store of the newest session."""
    return _REC.store


def _value(v):
    if callable(v):
        v = v()
    if isinstance(v, torch.Tensor):
        return v.item() if v.dim() == 0 else v.detach().cpu()
    return v


def spans(name: Optional[str] = None, st: Optional[Store] = None) -> list:
    """The recorded spans in the order they opened (those named `name`)."""
    st = st or store()
    return [s for s in st.spans if name is None or s.name == name]


def counts(name: str, st: Optional[Store] = None) -> list:
    """[(frame id, value)] of counter `name`, tensors read: a 0-dim one as
    a number, others as CPU tensors."""
    st = st or store()
    return [(f, _value(v)) for f, n, v in st.counts if n == name]


def total(name: str, st: Optional[Store] = None):
    """The sum of counter `name` over the store; None where it has none."""
    vals = [v for _, v in counts(name, st)]
    return sum(vals) if vals else None


def frame_ms(name: str, stream: bool = True,
             st: Optional[Store] = None) -> Optional[float]:
    """Span `name`'s stream ms (or host ms), summed and divided by the
    frames the store holds; None where no such span closed."""
    st = st or store()
    got = [s.stream_ms if stream else s.host_ms for s in spans(name, st)
           if s.end_ns is not None]
    if not got or None in got or not st.frames:
        return None
    return sum(got) / st.frames


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def table(st: Optional[Store] = None) -> list:
    """Per span name, in the order they first opened: {"name", "parent",
    "calls", "host_ms", "stream_ms", "self_ms"}, each ms per frame (the sum
    over the store's closed spans of that name over its frames; stream_ms
    None for host spans; self_ms the host ms less the part the span's
    children cover)."""
    st = st or store()
    kids = collections.defaultdict(list)
    for c in st.spans:
        if c.parent is not None and c.end_ns is not None:
            kids[id(c.parent)].append((c.start_ns, c.end_ns))
    rows = {}
    for s in st.spans:
        if s.end_ns is None:
            continue
        r = rows.setdefault(s.name, {
            "name": s.name, "parent": s.parent and s.parent.name,
            "calls": 0, "host_ms": 0.0, "stream_ms": 0.0, "self_ms": 0.0})
        r["calls"] += 1
        r["host_ms"] += s.host_ms
        r["self_ms"] += s.host_ms - busy_us(kids[id(s)]) / 1e6
        ms = s.stream_ms
        r["stream_ms"] = None if ms is None or r["stream_ms"] is None \
            else r["stream_ms"] + ms
    n = max(st.frames, 1)
    for r in rows.values():
        for k in ("host_ms", "stream_ms", "self_ms"):
            if r[k] is not None:
                r[k] /= n
    return list(rows.values())


def completed(names, st: Optional[Store] = None):
    """The oldest frame not returned before whose spans `names` have all
    closed and passed on the stream (Span.done: query(), never a wait):
    (frame id, {name: Span}); None where none has yet. A frame without
    all of them is passed over once a later frame has opened."""
    st = st or store()
    for f in range(st.handed + 1, st.frames):
        got = st.by_frame[f]
        if not all(n in got for n in names):
            if f == st.frames - 1:
                return None
            st.handed = f
            continue
        if not all(got[n].done() for n in names):
            return None
        st.handed = f
        return f, {n: got[n] for n in names}
    return None


def interval_ms(first: Span, last: Span) -> float:
    """Ms from `first`'s start to `last`'s end: on the stream where both
    are device spans, else on the host (CPU work runs as it is issued)."""
    if first.events is not None and last.events is not None:
        return first.events[0].elapsed_time(last.events[1])
    return (last.end_ns - first.start_ns) / 1e6


def _span_events(st: Store, base_ns: int) -> list:
    """Chrome trace events of the store's closed spans on their own row;
    a root span's args hold its frame's counters."""
    pid = os.getpid()
    per_frame = collections.defaultdict(dict)
    for f, name, v in st.counts:
        v = _value(v)
        per_frame[f][name] = v.tolist() if isinstance(v, torch.Tensor) \
            else v
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
            "args": {"name": SPAN_ROW}}]
    for s in st.spans:
        if s.end_ns is None:
            continue
        args = {"frame": s.frame, "parent": s.parent and s.parent.name}
        if s.events is not None:
            args["stream_ms"] = s.stream_ms
        if s.parent is None and per_frame.get(s.frame):
            args["counts"] = per_frame[s.frame]
        out.append({"ph": "X", "cat": "program_span", "name": s.name,
                    "pid": pid, "tid": SPAN_TID,
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def session(activities=(ProfilerActivity.CPU,)
            ) -> Iterator[torch.profiler.profile]:
    """A torch.profiler session (host operations only by default) whose
    spans and counters start a store of their own; yields the profiler."""
    with torch.profiler.profile(activities=list(activities)) as prof:
        _REC.store, _REC.stale = Store(), False
        yield prof


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block into logdir; yields the running profiler. Device
    activity is traced where torch.profiler supports CUDA. The block's
    spans start a new store and are written into the trace."""
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    os.makedirs(logdir, exist_ok=True)
    with session(activities) as prof:
        yield prof
    st = _REC.store
    if torch.cuda.is_available() and any(s.events for s in st.spans):
        torch.cuda.synchronize()
    path = os.path.join(logdir,
                        f"{socket.gethostname()}_{os.getpid()}{TRACE_SUFFIX}")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(_span_events(
        st, int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)


def trace_files(logdir: str) -> List[str]:
    """The traces trace() wrote into logdir, sorted."""
    return sorted(glob.glob(os.path.join(logdir, f"*{TRACE_SUFFIX}")))


def device_memory_stats(device=None) -> Optional[dict]:
    """torch.cuda.memory_stats of `device` (default: the current CUDA
    device when torch sees one), or None for a CPU device."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device)
