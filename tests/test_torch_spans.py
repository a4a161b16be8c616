"""The port's spans and counters (utils/profiling's recorder) on the CPU.

- Off (no torch.profiler session), a render records nothing and span()
  hands out one shared no-op; on or off, the engines run without their
  kIters instantiations.
- Under torch.profiler a render records its spans with their parents and
  frame ids, and the counters "rays" (the frame's total), for the other
  engines "raygen_kernel_rays" (0: the CPU runs the plain raygen) and, for
  the respawn engine, "warp_trips" (respawn_iters_reference of the frame's
  counts, taken when read); the other engines record no trips.
- A session opened by session() or trace() starts an empty store, and so
  does a torch.profiler session after a span that found recording off.
- trace() writes the spans into its Chrome trace on the host ops' axis.
- The sums that the per-frame readings take (frame_ms, total, table's
  self time, completed, interval_ms, shard.rank_timings and the median
  of busiest_collective_ms) on fake stores, and each of the benchmark's
  readers of the recorder (port_bench/metrics) on a fake store.
- The sharded path on two gloo ranks carries every rank's times of an
  earlier frame to each rank's recorder with the telemetry gather.

Counts and structure are exact; the fake stores' sums are exact binary
fractions.
"""

import contextlib
import importlib.util
import json
import pathlib
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad import inverse
from rays1bench_tpu_torch.kernels import megakernel, pipeline
from rays1bench_tpu_torch.kernels.pipeline import (prepare_trimmed,
                                                   render_image_megakernel)
from rays1bench_tpu_torch.parallel import shard
from rays1bench_tpu_torch.parallel.dryrun import run_ranks
from rays1bench_tpu_torch.scene import builders
from rays1bench_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = RenderConfig(width=32, height=16, spp=2, max_bounces=4)
ENGINES = {"respawn": dict(respawn=True),
           "oneshot": dict(respawn=False),
           "wavefront": dict(respawn=False, wavefront=(2, 3))}
SPANS = {"respawn": ["frame", "prepare", "kernel", "reduce"],
         "oneshot": ["frame", "prepare", "raygen", "kernel", "reduce"],
         "wavefront": ["frame", "prepare", "raygen", "kernel", "reduce"]}


@pytest.fixture(scope="module")
def medium():
    s = builders.create_medium_scene(CFG.aspect, device="cpu")
    return s, s.camera.build("cpu")


def render(scene, engine, cfg=CFG):
    s, camera = scene
    return render_image_megakernel(s.spheres, camera, cfg, n_real=s.n_real,
                                   **ENGINES[engine])


def spy_debug_iters(monkeypatch):
    """The debug_iters each engine call of the pipeline takes."""
    seen = []
    for name in ("trace_respawn", "trace_oneshot"):
        real = getattr(pipeline, name)

        def spy(*a, _real=real, **kw):
            seen.append(kw.get("debug_iters", False))
            return _real(*a, **kw)
        monkeypatch.setattr(pipeline, name, spy)
    return seen


def test_off_a_render_records_nothing(medium, monkeypatch):
    assert not profiling.recording()
    assert profiling.span("a") is profiling.span("b", device=True)
    before = profiling.store()
    n_spans, n_counts = len(before.spans), len(before.counts)
    launches = (megakernel.RESPAWN_ITERS_LAUNCHES,
                megakernel.ONESHOT_ITERS_LAUNCHES)
    seen = spy_debug_iters(monkeypatch)
    for engine in ENGINES:
        render(medium, engine)
    st = profiling.store()
    assert st is before
    assert (len(st.spans), len(st.counts)) == (n_spans, n_counts)
    assert seen == [False, False]
    assert (megakernel.RESPAWN_ITERS_LAUNCHES,
            megakernel.ONESHOT_ITERS_LAUNCHES) == launches


def respawn_counts(scene):
    """(rays, trips) of the respawn frame from the kernel's plain twin."""
    s, camera = scene
    packed = megakernel.pack_spheres(prepare_trimmed(s.spheres, s.n_real))
    _, cnt, total = megakernel.trace_respawn(
        packed, megakernel.pack_camera(camera), CFG)
    return int(total), int(megakernel.respawn_iters_reference(cnt,
                                                              CFG.width))


def test_a_profiled_render_records_its_spans_and_counters(medium,
                                                          monkeypatch):
    seen = spy_debug_iters(monkeypatch)
    launches = (megakernel.RESPAWN_ITERS_LAUNCHES,
                megakernel.ONESHOT_ITERS_LAUNCHES)
    off = [render(medium, e) for e in ENGINES]
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        on = [render(medium, e) for e in ENGINES]
    for (a, n), (b, m) in zip(off, on):
        assert torch.equal(a, b) and int(n) == int(m)
    assert seen == [False] * 4
    assert (megakernel.RESPAWN_ITERS_LAUNCHES,
            megakernel.ONESHOT_ITERS_LAUNCHES) == launches
    assert profiling.store().frames == 3
    for frame, engine in enumerate(ENGINES):
        got = [s for s in profiling.spans() if s.frame == frame]
        assert [s.name for s in got] == SPANS[engine]
        assert got[0].parent is None
        assert all(s.parent is got[0] for s in got[1:])
        assert all(s.events is None and s.host_ms > 0 for s in got)
        assert all(got[0].start_ns <= s.start_ns <= s.end_ns
                   <= got[0].end_ns for s in got[1:])
    rays = profiling.counts("rays")
    assert rays == [(f, int(n)) for f, (_, n) in enumerate(on)]
    # The CPU's frames run the plain raygen: the kernel made no rays.
    assert profiling.counts("raygen_kernel_rays") == [(1, 0), (2, 0)]
    (frame, trips), = profiling.counts("warp_trips")
    assert frame == 0 and (rays[0][1], trips) == respawn_counts(medium)


@pytest.mark.parametrize("opener", ["session", "trace", "profiler"])
def test_a_second_session_starts_empty(medium, tmp_path, opener):
    def open_session(k):
        if opener == "session":
            return profiling.session()
        if opener == "trace":
            return profiling.trace(str(tmp_path / str(k)))
        render(medium, "respawn")   # a span that finds recording off
        return profile(activities=[ProfilerActivity.CPU])

    with open_session(0):
        render(medium, "respawn")
        render(medium, "oneshot")
    assert profiling.store().frames == 2
    first = profiling.store()
    with open_session(1):
        render(medium, "oneshot")
    assert profiling.store() is not first
    assert profiling.store().frames == 1
    assert [s.name for s in profiling.spans()] == SPANS["oneshot"]
    assert [f for f, _ in profiling.counts("rays")] == [0]


def test_trace_writes_the_spans_on_the_host_ops_axis(medium, tmp_path):
    with profiling.trace(str(tmp_path)):
        _, n = render(medium, "oneshot")
    path, = profiling.trace_files(str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in mine] == SPANS["oneshot"]
    assert all(e["tid"] == profiling.SPAN_TID for e in mine)
    assert any(e.get("ph") == "M" and e.get("tid") == profiling.SPAN_TID
               and e["args"]["name"] == profiling.SPAN_ROW for e in events)
    frame, raygen = mine[0], mine[2]
    assert frame["args"]["counts"]["rays"] == int(n)
    assert raygen["args"] == {"frame": 0, "parent": "frame"}
    # The spans are on time.time_ns(), the profiler's clock: every host op
    # of the session lies inside the frame's span, and raygen's aten::arange
    # inside raygen's.
    ops = [e for e in events if e.get("ph") == "X"
           and e["name"].startswith("aten::")]
    assert ops and all(within(e, frame) for e in ops)
    assert any(e["name"] == "aten::arange" and within(e, raygen)
               for e in ops)


def within(event, sp):
    return sp["ts"] <= event["ts"] and \
        event["ts"] + event["dur"] <= sp["ts"] + sp["dur"]


def test_a_train_step_records_its_phases(medium):
    s, camera = medium
    cfg = RenderConfig(width=16, height=8, spp=1, max_bounces=3)
    inv = inverse.InverseConfig(learning_rate=1e-2,
                                optimize=("albedo_x", "albedo_y"))
    params = inverse.params_of(s.spheres, inv.optimize)
    step, _ = inverse.make_train_step(s.spheres, camera, cfg, inv, params,
                                      engine="pipeline")
    target = torch.full((cfg.height, cfg.width, 3), 0.3)
    with profiling.session():
        step(target)
        step(target)
    assert profiling.store().frames == 2
    names = ["step", "forward", "loss", "backward", "adam"]
    for frame in range(2):
        got = [x for x in profiling.spans() if x.frame == frame]
        assert [x.name for x in got] == names
        assert all(x.parent is got[0] for x in got[1:])


def fake_span(st, name, parent, start, end, frame=None):
    sp = profiling.Span(st, name, False)
    sp.parent, sp.start_ns, sp.end_ns = parent, start, end
    sp.frame = parent.frame if parent is not None else frame
    st.spans.append(sp)
    st.by_frame[sp.frame].setdefault(name, sp)
    return sp


def fake_frames(spans_ms):
    """A store of frames, each {name: (start ms, end ms)} of children of a
    "frame" span from the first start to the last end."""
    st = profiling.Store()
    for f, kids in enumerate(spans_ms):
        lo = min(a for a, _ in kids.values())
        hi = max(b for _, b in kids.values())
        root = fake_span(st, "frame", None, int(lo * 1e6), int(hi * 1e6), f)
        for name, (a, b) in kids.items():
            fake_span(st, name, root, int(a * 1e6), int(b * 1e6))
    st.frames = len(spans_ms)
    return st


def test_per_frame_readings_on_a_fake_store():
    st = fake_frames([
        {"prepare": (0.0, 0.5), "raygen": (0.5, 3.0), "kernel": (3.0, 9.0)},
        {"prepare": (10.0, 10.25), "raygen": (10.25, 14.0),
         "kernel": (15.0, 20.0)}])
    assert profiling.frame_ms("frame", stream=False, st=st) == 9.5
    assert profiling.frame_ms("raygen", stream=False, st=st) == 3.125
    assert profiling.frame_ms("prepare", stream=False, st=st) == 0.375
    # No span has stream ms on a fake host store.
    assert profiling.frame_ms("raygen", st=st) is None
    assert profiling.frame_ms("missing", stream=False, st=st) is None
    rows = {r["name"]: r for r in profiling.table(st)}
    # Frame 1's 1 ms between raygen and kernel is the frame's self time.
    assert rows["frame"]["self_ms"] == 0.5
    assert rows["kernel"] == {"name": "kernel", "parent": "frame",
                              "calls": 2, "host_ms": 5.5, "stream_ms": None,
                              "self_ms": 5.5}
    st.counts += [(0, "rays", 48), (0, "warp_trips", 2),
                  (1, "rays", torch.tensor(80)),
                  (1, "warp_trips", torch.tensor(3))]
    occupancy = 100 * profiling.total("rays", st) / (
        megakernel.WARP_LANES * profiling.total("warp_trips", st))
    assert occupancy == 80.0


def test_completed_hands_out_each_done_frame_once():
    names = ("frame", "local", "all_reduce", "all_gather")
    full = lambda t: {"local": (t, t + 1), "all_reduce": (t + 1, t + 2),
                      "all_gather": (t + 2, t + 4)}
    # Frame 2 lacks the collectives: passed over once frame 3 has opened.
    st = fake_frames([full(0), full(5), {"local": (10, 11)}, full(12)])
    f, got = profiling.completed(names, st)
    assert f == 0 and got["local"].start_ns == 0
    assert profiling.interval_ms(got["all_reduce"], got["all_gather"]) == 3.0
    assert [profiling.completed(names, st)[0] for _ in range(2)] == [1, 3]
    assert profiling.completed(names, st) is None
    # A frame still open is not done, nor a last frame lacking a span.
    st = profiling.Store()
    root = fake_span(st, "frame", None, 0, None, 0)
    fake_span(st, "local", root, 0, 1_000_000)
    st.frames = 1
    assert profiling.completed(("frame",), st) is None
    assert profiling.completed(names, st) is None
    root.end_ns = 2_000_000
    assert profiling.completed(("frame",), st)[0] == 0


def rank_row(rays, iters, frame, local, coll, issue):
    ints = torch.tensor([rays, iters], dtype=torch.int64)
    ms = torch.tensor([frame, local, coll, issue], dtype=torch.float64)
    return torch.cat([ints, ms.view(torch.int64)])


def test_busiest_rank_collective_ms_on_a_fake_store():
    st = profiling.Store()
    # Frame 0: rank 1 is the busiest; nobody has sent times yet.
    st.counts.append((0, "ranks", torch.stack([
        rank_row(10, 40, -1, 0, 0, 0), rank_row(20, 90, -1, 0, 0, 0)])))
    # Frame 1: rank 0 the busiest; both send frame 0's times.
    st.counts.append((1, "ranks", torch.stack([
        rank_row(30, 95, 0, 2.5, 8.0, 1.0),
        rank_row(20, 90, 0, 9.0, 1.5, 1.25)])))
    # Frame 2: rank 1 sends frame 1's times, rank 0 none yet.
    st.counts.append((2, "ranks", torch.stack([
        rank_row(10, 40, -1, 0, 0, 0), rank_row(20, 90, 1, 7.0, 0.75,
                                                2.0)])))
    timings = shard.rank_timings(st)
    assert timings == {
        0: {"busiest": 1, "ranks": {
            0: {"local_ms": 2.5, "collective_ms": 8.0, "issue_ms": 1.0},
            1: {"local_ms": 9.0, "collective_ms": 1.5, "issue_ms": 1.25}}},
        1: {"busiest": 0, "ranks": {
            1: {"local_ms": 7.0, "collective_ms": 0.75, "issue_ms": 2.0}}}}
    # Frame 1's busiest rank (0) never sent its times: frame 0 alone.
    assert shard.busiest_collective_ms(st) == 1.5
    assert shard.busiest_collective_ms(profiling.Store()) is None


def busiest_store(collective_ms):
    """A store of one rank whose frame f carries frame f - 1's times, the
    collectives of frame f taking collective_ms[f]."""
    st = profiling.Store()
    for f in range(len(collective_ms) + 1):
        done = [f - 1, 2.0, collective_ms[f - 1], 3.0] if f else [-1] * 4
        st.counts.append((f, "ranks", torch.stack([rank_row(8, 20, *done)])))
    return st


def test_busiest_collective_ms_is_the_median_over_frames():
    # A session's first frame waits for the other ranks' profilers to
    # start; the median reads the steady frames.
    st = busiest_store([900.0, 0.5, 0.75, 0.625])
    assert sorted(shard.rank_timings(st)) == [0, 1, 2, 3]
    assert shard.busiest_collective_ms(st) == 0.6875


def sharded_frames(frames):
    """A rank of test_sharded_frames_carry_every_ranks_times: `frames`
    sharded respawn frames with telemetry in a session; returns what the
    rank's recorder holds."""
    import torch.distributed as dist

    from rays1bench_tpu_torch.parallel.mesh import make_mesh
    s = builders.create_medium_scene(CFG.aspect, device="cpu")
    camera = s.camera.build("cpu")
    mesh = make_mesh(device="cpu")
    off = shard.render_image_pallas_sharded(
        s.spheres, camera, CFG, mesh, n_real=s.n_real, respawn=True,
        telemetry=True)
    # A rank that records and one that does not gather rows of one length.
    with (profiling.session() if dist.get_rank() == 0
          else contextlib.nullcontext()):
        shard.render_image_pallas_sharded(
            s.spheres, camera, CFG, mesh, n_real=s.n_real, respawn=True,
            telemetry=True)
    with profiling.session():
        outs = [shard.render_image_pallas_sharded(
            s.spheres, camera, CFG, mesh, n_real=s.n_real, respawn=True,
            telemetry=True) for _ in range(frames)]
    return {"off": off[2], "telemetry": [o[2] for o in outs],
            "names": [(x.name, x.parent and x.parent.name, x.frame)
                      for x in profiling.spans()],
            "rays": profiling.counts("rays"),
            "trips": profiling.counts("warp_trips"),
            "ranks": profiling.counts("ranks"),
            "timings": shard.rank_timings(),
            "busiest": shard.busiest_collective_ms()}


def test_sharded_frames_carry_every_ranks_times(tmp_path):
    frames = 3
    got = run_ranks(sharded_frames, 2, str(tmp_path), frames)
    local = ["frame", "local", "prepare", "kernel", "all_reduce",
             "all_gather", "assemble", "telemetry"]
    parents = [None, "frame", "local", "local", "frame", "frame", "frame",
               "frame"]
    for r in got:
        assert r["off"]["device_iters"].shape == (2,)
        assert r["names"] == [(n, p, f) for f in range(frames)
                              for n, p in zip(local, parents)]
        assert [f for f, _ in r["trips"]] == list(range(frames))
        for f in range(frames):
            rows = shard.rank_rows(r["ranks"][f][1])
            tel = r["telemetry"][f]
            assert [x["rays"] for x in rows] == tel["device_rays"].tolist()
            assert [x["iters"] for x in rows] == \
                tel["device_iters"].tolist()
            # Each rank sends the frame before this one, once it is done.
            assert [x["frame"] for x in rows] == [f - 1.0] * 2
        assert r["ranks"][0][1].shape == (2, len(shard.RANK_ROW))
        assert sorted(r["timings"]) == list(range(frames - 1))
        for f, t in r["timings"].items():
            trips = [int(x) for x in r["telemetry"][f]["device_iters"]]
            assert t["busiest"] == trips.index(max(trips))
            for ms in t["ranks"].values():
                assert 0 < ms["local_ms"] < ms["issue_ms"]
                assert 0 < ms["collective_ms"] < ms["issue_ms"]
        want = [t["ranks"][t["busiest"]]["collective_ms"]
                for t in r["timings"].values()]
        assert r["busiest"] == statistics.median(want)
    assert got[0]["timings"] == got[1]["timings"]


METRICS = pathlib.Path(__file__).resolve().parents[1] / "port_bench" / \
    "metrics"


def reader(name):
    """The benchmark's reader of metric `name`, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"reader_{name.replace('.', '_')}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cli_store():
    """Two CLI frames' spans: "frame" of 9.5 and 10 host ms, "prepare" of
    0.5 and 0.25, "raygen" of 2.5 and 3.75; the counters of two respawn
    frames (48 + 80 rays in 2 + 3 warp trips, one counter a tensor and one
    taken when read)."""
    st = fake_frames([
        {"prepare": (0.0, 0.5), "raygen": (0.5, 3.0), "kernel": (3.0, 9.5)},
        {"prepare": (10.0, 10.25), "raygen": (10.25, 14.0),
         "kernel": (14.0, 20.0)}])
    st.counts += [(0, "rays", 48), (0, "warp_trips", lambda: 2),
                  (1, "rays", torch.tensor(80)),
                  (1, "warp_trips", torch.tensor(3))]
    return st


class StreamSpan:
    """A closed device span whose stream ms is its host ms."""

    def __init__(self, sp):
        self.sp = sp

    def __getattr__(self, name):
        return getattr(self.sp, name)

    @property
    def stream_ms(self):
        return self.sp.host_ms


@pytest.mark.parametrize("name, want", [
    ("lane_occupancy", 100.0 * 128 / (32 * 5)),
    ("host_issue_ms.cli", (9.5 + 10.0) / 2),
    ("raygen_ms.cli", (2.5 + 3.75) / 2),
    ("prepare_ms.cli", (0.5 + 0.25) / 2),
    ("collective_ms.x4", 0.6875)])
def test_each_reader_reads_its_definition_on_a_fake_store(name, want,
                                                          monkeypatch):
    mod = reader(name)
    assert (mod.UNIT, mod.MOVES) == (
        {"lane_occupancy": "%"}.get(name, "ms"),
        {"lane_occupancy": "mrays_per_s",
         "collective_ms.x4": "mrays_per_s.x4"}.get(name, "mrays_per_s.cli"))
    if name == "collective_ms.x4":
        st = busiest_store([900.0, 0.5, 0.75, 0.625])
    else:
        st = cli_store()
        # A card's spans: stream ms where the reader takes them.
        st.spans = [StreamSpan(x) for x in st.spans]
    monkeypatch.setattr(profiling._REC, "store", st)
    assert mod.read({}, METRICS.parent) == want
    # A store with nothing recorded: nothing to read, and no error.
    monkeypatch.setattr(profiling._REC, "store", profiling.Store())
    assert mod.read({}, METRICS.parent) is None


@pytest.mark.parametrize("name", ["lane_occupancy", "host_issue_ms.cli",
                                  "collective_ms.x4"])
def test_a_reader_reads_nothing_from_a_program_without_the_recorder(
        name, monkeypatch):
    for attr in ("total", "frame_ms"):
        monkeypatch.delattr(profiling, attr)
    monkeypatch.delattr(shard, "busiest_collective_ms")
    assert reader(name).read({}, METRICS.parent) is None
