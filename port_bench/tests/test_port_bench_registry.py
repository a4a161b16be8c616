"""CPU tests of the benchmark's registry, counts, result line, trace
arithmetic and imports.

    python -m pytest -o addopts= port_bench/tests
"""

import ast
import json
import re
import shutil

import pytest

from port_bench import harness, roofline, trace

ROOT = harness.ROOT
REPO = ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def one_line(text, most=200):
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_benchmark_file_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(one_line(w) for w in BENCH["command"])
    for kind, keys in ENTRY_KEYS.items():
        for e in BENCH[kind]:
            assert set(e) <= keys, (kind, e["name"])
            assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_metrics_units_sources_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert one_line(m["layer"])
        # Every per-layer metric names the cells it is read in, and each of
        # them reports the end-to-end metric it moves.
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w]), m["name"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader_that_agrees(metric):
    mod = harness.load_module("metrics", metric)
    entry = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                 if m["name"] == metric)
    assert mod.UNIT == entry["unit"]
    if "layer" in entry:
        assert mod.LAYER == entry["layer"]
        assert mod.MOVES == entry["moves"]


@pytest.mark.parametrize("entry", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_workload_files_match_the_benchmark(entry):
    raw = harness.load_json("workloads", entry["name"])
    assert (raw["config"], raw["traffic"], raw["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    w = harness.cell(entry["name"])
    assert w["config"]["name"] == entry["config"]
    assert entry["chips"] in (1, 4)
    assert one_line(entry["why"])
    assert w["limits"], "a cell is judged by at least one number"
    reported = harness.metrics_for(BENCH, entry["name"], False)
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.metrics_for(BENCH, entry["name"], True)


@pytest.mark.parametrize("name", harness.list_cells())
def test_every_workload_file_meets_the_schema(name):
    w = harness.cell(name)
    assert set(harness.load_json("workloads", name)) == {
        "name", "config", "traffic", "chips", "limits"}
    for key in (w["name"], w["config"]["name"], harness.load_json(
            "workloads", name)["traffic"]):
        assert NAME.match(key), key
    assert w["chips"] in (1, 4)
    assert all(isinstance(v, (int, float)) and v >= 0
               for v in w["limits"].values())
    assert w["traffic"]["loop"] in ("render", "fit", "sharded")
    harness.load_module("loops", w["traffic"]["loop"], ROOT)


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_config_file_meets_the_schema(path):
    cfg = json.loads(path.read_text())
    assert cfg["name"] == path.stem and NAME.match(cfg["name"])
    assert cfg["reduced"] == [] and cfg["precision"] == "float32"
    assert set(cfg["render"]) == {"width", "height", "spp", "max_bounces"}
    assert one_line(cfg["source"]) and cfg["source"].startswith("http")


def test_four_chip_cells_within_a_quarter():
    fours = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_files(entry):
    path = REPO / entry["file"]
    assert path.parts[len(REPO.parts)] == "port_bench"
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert one_line(entry["source"]) and entry["source"].startswith("http")
    assert set(cfg["render"]) == {"width", "height", "spp", "max_bounces"}
    assert cfg["precision"] == "float32"
    used = [w for w in BENCH["workloads"] if w["config"] == entry["name"]]
    assert used, "every configuration is used by a cell"


def test_a_cell_is_added_from_files_alone(tmp_path):
    root = tmp_path / "port_bench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic" / "cli_frame_spp4.json").write_text(json.dumps(
        dict(harness.load_json("traffic", "cli_frame"),
             render={"spp": 4})))
    (root / "workloads" / "large.cli_frame_spp4.json").write_text(json.dumps(
        {"name": "large.cli_frame_spp4", "config": "rtiow_large",
         "traffic": "cli_frame_spp4", "chips": 1,
         "limits": {"pixel_gap": 0.01}}))
    assert "large.cli_frame_spp4" in harness.list_cells(root)
    assert set(harness.list_cells(ROOT)) < set(harness.list_cells(root))
    c = harness.cell("large.cli_frame_spp4", root)
    assert c["traffic"]["render"] == {"spp": 4}
    assert c["config"]["render"]["width"] == 1280


def test_counts_against_a_hand_count():
    respawn = harness.load_module("counts", "respawn")
    oneshot = harness.load_module("counts", "oneshot")
    backward = harness.load_module("counts", "mega_backward")
    # 2x2 pixels, a table of 8 rows of which 5 are spheres, 10 rays traced:
    # 4 * (7*8 + 19 + 4*4) bytes; 10 rays * 5 spheres * 16 operations.
    assert respawn.work(4, 8, 5, 10) == (4 * (56 + 19 + 16), 800)
    # 3 primary rays, 2 bounces: 7 + 4 planes (+ 3 topology planes).
    assert oneshot.work(3, 8, 5, 10, 2, False) == (4 * (56 + 3 * 11), 800)
    assert oneshot.work(3, 8, 5, 10, 2, True) == (4 * (56 + 3 * 14), 800)
    # 21 rows a sphere; 10 + 3 + 6 planes a ray; 270 operations a bounce.
    assert backward.work(3, 8, 10, 2) == (4 * (21 * 8 + 3 * 19), 2700)


def test_roofline_share_from_a_fake_trace():
    p = roofline.peaks(ROOT)
    ops = 10 * p["fp32_ops_per_s"]       # ten seconds of operations
    result = {"trace": {"busy_s": 1.0, "window_s": 1.0, "ops": {
        "void r1b::respawn_kernel<false>(float const*, int)": [40.0, 2]}}}
    got = roofline.share(result, "respawn_kernel", (1.0, ops), ROOT)
    assert got == pytest.approx(50.0)
    assert roofline.share(result, "oneshot_kernel", (1.0, ops), ROOT) is None
    assert roofline.share({"trace": None}, "respawn_kernel", (1, 1),
                          ROOT) is None


def test_kernel_names_match_whole_functions():
    assert trace.is_kernel("r1b::oneshot_kernel(float const*)",
                           "oneshot_kernel")
    assert trace.is_kernel("void r1b::respawn_kernel<true>(float*)",
                           "respawn_kernel")
    assert not trace.is_kernel("oneshot_kernel_helper(float)",
                               "oneshot_kernel")
    assert not trace.is_kernel("void at::indexing_backward_kernel<float>()",
                               "backward_kernel")


def test_busy_us_counts_overlaps_once():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert trace.busy_us([]) == 0
    assert trace.merged([(5, 15), (0, 10), (20, 30)]) == [[0, 15], [20, 30]]


def test_idle_gaps_are_named_by_the_host():
    device = [(0, 10), (30, 40), (41, 50)]
    host = [("cudaStreamSynchronize", 5, 35), ("aten::item", 12, 29),
            ("python", 39, 42)]
    gaps = trace.idle_gaps(device, host)
    assert gaps[0] == ["aten::item", 20 / 1e6]
    assert gaps[1] == ["python", 1 / 1e6]


def test_summary_and_readers_on_fake_events():
    dev = [("r1b::respawn_kernel(float)", 0.0, 300_000.0),
           ("elementwise", 300_000.0, 301_000.0),
           ("r1b::respawn_kernel(float)", 302_000.0, 602_000.0),
           ("ncclDevKernel_AllReduce_Sum_u64_RING_LL(x)", 602_000.0,
            607_000.0),
           ("nccl:all_reduce", 602_000.0, 607_000.0)]
    s = dict(trace.summarize(dev, [("aten::copy_", 301_000.0, 302_000.0)],
                             0.61), units=2)
    assert s["busy_s"] == pytest.approx(0.606)
    assert s["compute_s"] == pytest.approx(0.601)
    assert trace.kernel_time(s, "respawn_kernel") == pytest.approx((0.6, 2))
    s["rank0_window_s"] = 0.61
    result = {"trace": s, "frames": 2, "rays": 10 ** 9, "window_s": 0.61,
              "setup_s": 3.0, "frame_rays": 5 * 10 ** 8,
              "shape": {"pixels": 100, "spp": 1, "max_bounces": 1,
                        "real": 4, "rows": 8}}
    names = ["mrays_per_s", "mrays_per_s.cli", "setup_s", "respawn_roofline",
             "idle_share.headline", "idle_share.x4", "torch_ops_ms.cli",
             "oneshot_roofline.cli", "step_ms", "idle_share.fit"]
    got = harness.read_metrics(names, result)
    assert got["mrays_per_s"]["value"] == pytest.approx(1e9 / 0.61 / 1e6)
    assert got["mrays_per_s.cli"] == got["mrays_per_s"]
    assert got["setup_s"] == {"value": 3.0, "unit": "s"}
    assert got["idle_share.headline"]["value"] == pytest.approx(
        100 * (1 - 0.606 / 0.61))
    # The collectives' spin is no work: the four cards' idle share leaves
    # it out of busy.
    assert got["idle_share.x4"]["value"] == pytest.approx(
        100 * (1 - 0.601 / 0.61))
    assert got["torch_ops_ms.cli"]["value"] == pytest.approx(0.5)
    want = 100 * 2 * (5e8 * 4 * 16 / 3.35e13) / 0.6
    assert got["respawn_roofline"]["value"] == pytest.approx(want)
    # No launch of the one-shot kernel in the trace: its roofline finds
    # nothing, and the run counts it as unread rather than leave it out.
    assert harness.unread(names, got) == [
        "oneshot_roofline.cli", "step_ms", "idle_share.fit"]


def test_result_line_from_fake_readings():
    correct, checks = harness.judge({"pixel_gap": 0.0, "rays_gap": 0.01},
                                    {"pixel_gap": 1e-3, "rays_gap": 0.05})
    assert correct
    line = harness.result_line(
        correct, 57, 0, {"mrays_per_s": {"value": 1812.5, "unit": "mrays/s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 123}, checks,
        {"device_ops": [["k", 1.0]], "idle_gaps": [["python", 0.1]]})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics", "device",
                       "breakdown", "checks"]
    assert d["checks"]["rays_gap"] == {"value": 0.01, "limit": 0.05}
    assert not harness.judge({"pixel_gap": 2e-3}, {"pixel_gap": 1e-3})[0]
    assert not harness.judge({}, {"pixel_gap": 1e-3})[0]
    ok, bad = harness.judge({"pixel_gap": float("inf")}, {"pixel_gap": 1e-3})
    assert not ok and bad["pixel_gap"]["value"] is None
    assert harness.checks_text(checks)[0] == \
        "check pixel_gap: 0.0 limit 0.001"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_and_a_reference_apart_from_the_program(path):
    names = set(_imports(path))
    assert not names & set(harness.FORBIDDEN), names
    if "reference" in path.relative_to(ROOT).parts:
        assert "rays1bench_tpu_torch" not in names
        assert names <= {"__future__", "math", "struct", "numpy", "torch",
                         "port_bench"}


def test_forbidden_modules_compared_by_whole_top_level_name(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "rays1bench_tpu_torch_like",
                        types.ModuleType("rays1bench_tpu_torch_like"))
    assert "rays1bench_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_loaded() == ["jax"]
