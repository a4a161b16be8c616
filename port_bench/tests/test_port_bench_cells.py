"""Every cell driven on the CPU at a tiny size, past the harness's look for a
card: the program's plain versions come out correct; the control (the
plain reference in bfloat16 in the program's place) and each fault the cell
can have, planted under the timed path, come out not correct.

    python -m pytest -o addopts= port_bench/tests
"""

import importlib
import json
import time

import numpy as np
import pytest
import torch

from port_bench import control, faults, harness
from port_bench.loops import common
from port_bench.reference import render, scenes

SMALL = {"render": {"width": 32, "height": 16, "spp": 2, "max_bounces": 4},
         "check_tile": [1, 1], "ranks": 2}
SEED = 2 ** 31 + 987_654_321
BENCH = harness.benchmark_file()
# Every cell the files define, those BENCHMARK.json leaves out too.
CELLS = harness.list_cells()
ONE_CARD_RENDERS = [c for c in CELLS
                    if harness.cell(c)["traffic"]["loop"] == "render"]
FITS = [c for c in CELLS if harness.cell(c)["traffic"]["loop"] == "fit"]
SHARDED = [c for c in CELLS
           if harness.cell(c)["traffic"]["loop"] == "sharded"]


def small_run(name, seed=SEED, trace=False, seconds=0.05):
    return common.Run(harness.cell(name), seed, seconds, trace,
                      torch.device("cpu"), time.perf_counter(), SMALL)


def drive(name, seed=SEED, trace=False, seconds=0.05):
    run = small_run(name, seed, trace, seconds)
    loop = importlib.import_module(
        f"port_bench.loops.{run.cell['traffic']['loop']}")
    return loop.run(run)


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_cpu(name):
    res = drive(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    got = harness.read_metrics(harness.metrics_for(BENCH, name, False), res)
    assert set(got) == set(harness.metrics_for(BENCH, name, False))
    assert all(v["value"] > 0 for v in got.values())


@pytest.mark.parametrize("name", ONE_CARD_RENDERS + FITS + SHARDED)
def test_traced_run_reads_its_metrics(name):
    res = drive(name, trace=True)
    assert res["correct"]
    assert res["trace"]["window_s"] > 0
    got = harness.read_metrics(harness.metrics_for(BENCH, name, True), res)
    # No device on the CPU: the rooflines find no kernel and stay silent.
    assert not any("roofline" in k for k in got)


def reference_frame(soa, camera, cfg, n_real=None, respawn=True,
                    wavefront=None, dtype=torch.bfloat16):
    """The plain reference in the program's place: the whole frame."""
    cols = {k: getattr(soa, k).cpu().numpy() for k in scenes.COLUMNS}
    img, cnt = render.render_pixels(
        cols, scenes.CAMERA, np.arange(cfg.width * cfg.height), cfg.width,
        cfg.height, cfg.spp, cfg.seed, cfg.max_bounces, "cpu", dtype, respawn)
    return img.reshape(cfg.height, cfg.width, 3), cnt.sum()


@pytest.mark.parametrize("name", ONE_CARD_RENDERS)
def test_control_in_the_programs_place_is_not_correct(name, monkeypatch):
    from rays1bench_tpu_torch.kernels import pipeline
    monkeypatch.setattr(pipeline, "render_image_megakernel", reference_frame)
    res = drive(name)
    assert not res["correct"]
    assert res["checks"]["pixel_gap"]["value"] > \
        res["checks"]["pixel_gap"]["limit"]


@pytest.mark.parametrize("name", ONE_CARD_RENDERS)
def test_float32_reference_in_the_programs_place_is_correct(name,
                                                            monkeypatch):
    from rays1bench_tpu_torch.kernels import pipeline
    monkeypatch.setattr(
        pipeline, "render_image_megakernel",
        lambda *a, **k: reference_frame(*a, **k, dtype=torch.float32))
    assert drive(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_readings_fail_the_limits(name):
    values = control.values(small_run(name))
    correct, _ = harness.judge(values, harness.cell(name)["limits"])
    assert not correct, values


@pytest.mark.parametrize("fault", faults.RENDER)
@pytest.mark.parametrize("name", ONE_CARD_RENDERS)
def test_render_faults_are_not_correct(name, fault):
    with faults.render_fault(fault):
        assert not drive(name)["correct"]


@pytest.mark.parametrize("fault", faults.FIT)
@pytest.mark.parametrize("name", FITS)
def test_fit_faults_are_not_correct(name, fault):
    with faults.fit_fault(fault):
        res = drive(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_exchange_left_out_is_not_correct(name):
    with faults.exchange_fault():
        assert not drive(name)["correct"]


def test_a_wavefront_cell_is_added_from_data_alone(tmp_path, monkeypatch):
    root = tmp_path / "port_bench"
    root.mkdir()
    for kind in ("configs", "traffic", "workloads"):
        (root / kind).mkdir()
    cfg = harness.load_json("configs", "rtiow_large")
    (root / "configs" / "rtiow_large.json").write_text(json.dumps(cfg))
    (root / "traffic" / "cli_wavefront.json").write_text(json.dumps(dict(
        harness.load_json("traffic", "cli_frame"), engine="wavefront",
        schedule=[2, 3, 6])))
    (root / "workloads" / "large.cli_wavefront.json").write_text(json.dumps(
        dict(harness.load_json("workloads", "large.cli_frame"),
             name="large.cli_wavefront", traffic="cli_wavefront")))
    run = common.Run(harness.cell("large.cli_wavefront", root), SEED, 0.05,
                     False, torch.device("cpu"), time.perf_counter(), SMALL)
    res = importlib.import_module("port_bench.loops.render").run(run)
    assert res["correct"], res["checks"]


def test_counts_of_a_frame_are_compared_across_frames(monkeypatch):
    from rays1bench_tpu_torch.kernels import pipeline
    real = pipeline.render_image_megakernel
    name = ONE_CARD_RENDERS[0]
    first = harness.cell(name)["traffic"]["warmup_frames"] + 1
    calls = []

    def drifting(*a, **k):
        img, total = real(*a, **k)
        calls.append(1)
        return img, total + (len(calls) == first)

    monkeypatch.setattr(pipeline, "render_image_megakernel", drifting)
    # Three timed frames, however slow the host: the window's end is the
    # loop's to decide, not this test's.
    loop = common.closed_loop
    monkeypatch.setattr(common, "closed_loop",
                        lambda frame, k, dev, win, done:
                        loop(frame, k, dev, win, lambda n: n >= 3))
    res = drive(name)
    assert res["attempted"] == 3
    assert not res["correct"] and res["failed"] == 1
