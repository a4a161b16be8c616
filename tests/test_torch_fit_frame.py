"""The albedo fit at the reference's frame (the benchmark's cell
frame_fit.albedo), cut to 32x16 @ 2 spp @ 4 bounces on the CPU, where the
port's kernels run as their plain versions:

- the port's "mega" training step follows reference/fit_frame.py (the
  plain fit computed in blocks of whole pixels): losses, first gradient and
  the albedos' change over three steps;
- reference/fit_frame.py in one block or in several equals reference/fit.py
  to float32 rounding, and sums each albedo row's cotangents in float64;
- the step's ray total (step.rays, and the recorder's counter "rays")
  equals the reference's count, and is kept on the step's device;
- a recorded step holds the forward's spans "prepare", "raygen",
  "kernel" and "reduce" and the backward's "backward_kernel"; with the
  recorder off a step records nothing;
- the cell is correct through port_bench/loops/fit_frame.py, with its
  ray count equal to the reference's, and the control and each of its
  faults (faults.py's fit faults and a step that over-counts its rays)
  are not; a program whose step keeps no ray total fails the cell before
  it renders anything;
- the cell's four per-layer readers read their definitions from fake
  results, and nothing where the program leaves them nothing.
"""

import importlib
import time

import numpy as np
import pytest
import torch

from port_bench import faults, harness, roofline
from port_bench.loops import common
from port_bench.loops import fit as fit_loop
from port_bench.loops import fit_frame as loop
from port_bench.reference import fit, fit_frame, scenes
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad import inverse
from rays1bench_tpu_torch.utils import profiling

torch.set_num_threads(1)

CELL = "frame_fit.albedo"
W, H, SPP, MB = 32, 16, 2, 4
SMALL = {"render": {"width": W, "height": H, "spp": SPP, "max_bounces": MB}}
SEED = 2 ** 31 + 555_000_111
COLS, N_REAL = scenes.large_scene(128)
STEP_SPANS = ["step", "forward", "prepare", "raygen", "kernel", "reduce",
              "loss", "backward", "backward_kernel", "adam"]


def albedos(seed):
    """(true, start) albedos (3, S), the cell's perturbation from seed."""
    return fit_loop.start_albedo(COLS, N_REAL, np.random.default_rng(seed),
                                 0.6, 0.9)


def step_of(start, seed=77):
    """The port's mega step at the cut size from `start`, its parameters,
    optimizer and target (rendered from the true albedos)."""
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_bounces=MB, seed=seed,
                       early_exit=False)
    soa, camera = common.program_scene(COLS, scenes.CAMERA, SMALL["render"],
                                       torch.device("cpu"))
    with torch.no_grad():
        target = inverse.render_for_loss(soa, camera, cfg, engine="mega")
    begin = inverse.with_params(soa, {k: torch.from_numpy(start[i].copy())
                                      for i, k in enumerate(fit.LEAVES)})
    params = inverse.params_of(begin, fit.LEAVES)
    step, opt = inverse.make_train_step(
        begin, camera, cfg,
        inverse.InverseConfig(learning_rate=0.01, optimize=fit.LEAVES),
        params, engine="mega")
    return step, params, opt, target


def frame_reference(true, start, seed=77, steps=3, **kw):
    return fit_frame.fit_reference(COLS, true, start, scenes.CAMERA, W, H,
                                   SPP, seed, MB, 0.01, steps, **kw)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_mega_step_follows_the_block_reference(seed):
    true, start = albedos(seed)
    step, params, opt, target = step_of(start)
    prog = {"losses": [], "start": {k: torch.from_numpy(start[i].copy())
                                    for i, k in enumerate(fit.LEAVES)}}
    for i in range(3):
        prog["losses"].append(float(step(target)))
        if i == 0:
            prog["grad1"] = {k: opt.state[p]["exp_avg"] / (1 - fit.BETAS[0])
                             for k, p in params.items()}
    prog["params"] = {k: p.detach().clone() for k, p in params.items()}
    ref = frame_reference(true, start, block_pixels=100)
    gaps = fit_loop.judge_fit(prog, ref)
    assert gaps["loss_gap"] <= 1e-6, gaps
    assert gaps["grad_gap"] <= 1e-5, gaps
    assert gaps["change_gap"] <= 1e-5, gaps
    assert ref["losses"][2] < ref["losses"][0]


@pytest.mark.parametrize("block_pixels", [W * H, 100, 7])
def test_blocks_give_the_whole_frame_reference(block_pixels):
    true, start = albedos(11)
    whole = fit.fit_reference(COLS, true, start, scenes.CAMERA, W, H, SPP,
                              77, MB, 0.01, 3)
    got = frame_reference(true, start, block_pixels=block_pixels)
    assert got["rays"] == whole["rays"]
    assert got["losses"] == pytest.approx(whole["losses"], rel=1e-6)
    for part in ("grad1", "params"):
        for k in fit.LEAVES:
            a, b = got[part][k], whole[part][k]
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_a_rows_gradient_is_summed_in_float64():
    g = torch.Generator().manual_seed(3)
    table = torch.rand((4, 3), generator=g).requires_grad_(True)
    row = torch.randint(0, 4, (1 << 18,), generator=g)
    row[:3] = torch.arange(3)
    ct = torch.randn((row.numel(), 3), generator=g) * 1e-3 + 1e-4
    fit_frame.Rows.apply(table, row).backward(ct)
    want = torch.zeros(4, 3, dtype=torch.float64).index_add_(
        0, row, ct.double()).float()
    assert torch.equal(table.grad, want)
    assert torch.equal(fit_frame.Rows.apply(table, row), table[row])


def test_the_steps_ray_total_is_the_references_count():
    true, start = albedos(5)
    step, _, _, target = step_of(start)
    assert step.rays is None
    step(target)
    first = step.rays
    assert first.dtype == torch.int64 and first.dim() == 0
    with profiling.session():
        step(target)
    counted = profiling.total("rays")
    want = frame_reference(true, start, steps=1)["rays"]
    assert int(first) == int(step.rays) == counted == want
    assert want > W * H * SPP


def test_a_recorded_step_holds_the_kernels_spans():
    _, start = albedos(6)
    step, _, _, target = step_of(start)
    step(target)
    st = profiling.store()
    before = (len(st.spans), len(st.counts))
    step(target)        # off: nothing recorded
    assert profiling.store() is st
    assert (len(st.spans), len(st.counts)) == before
    with profiling.session():
        step(target)
        step(target)
    assert profiling.store().frames == 2
    for frame in range(2):
        got = {x.name: x for x in profiling.spans() if x.frame == frame}
        assert [x.name for x in profiling.spans()
                if x.frame == frame] == STEP_SPANS
        for name in ("prepare", "raygen", "kernel", "reduce"):
            assert got[name].parent is got["forward"]
        assert got["backward_kernel"].parent is got["backward"]
        assert all(x.end_ns is not None for x in got.values())


def small_run(seed=SEED, trace=False):
    return common.Run(harness.cell(CELL), seed, 0.05, trace,
                      torch.device("cpu"), time.perf_counter(), SMALL)


def test_the_cell_is_correct_through_its_loop():
    cell = harness.cell(CELL)
    assert cell["traffic"]["loop"] == "fit_frame"
    res = loop.run(small_run())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["steps"] >= 1
    assert res["rays"] == res["steps"] * res["step_rays"]
    assert res["step_rays"] == res["reference_rays"]
    assert res["checks"]["rays_gap"] == {"value": 0.0, "limit": 0}
    bench = harness.benchmark_file()
    got = harness.read_metrics(harness.metrics_for(bench, CELL, False), res)
    assert set(got) == {"mrays_per_s", "setup_s"}
    assert got["mrays_per_s"]["value"] == pytest.approx(
        res["rays"] / res["window_s"] / 1e6)


@pytest.mark.parametrize("fault", loop.FAULTS)
def test_each_fit_fault_fails_the_cell(fault):
    plant, names = faults.FAULTS["fit_frame"]
    assert plant is loop.fit_frame_fault and names == loop.FAULTS
    with plant(fault):
        res = loop.run(small_run())
    assert not res["correct"], res["checks"]
    if fault == "count":
        assert res["checks"]["rays_gap"]["value"] == pytest.approx(
            0.01, abs=1e-3)
        assert all(c["value"] <= c["limit"] for k, c in res["checks"].items()
                   if k != "rays_gap"), res["checks"]


@pytest.mark.parametrize("step_rays, window_rays, steps, gap", [
    (100, 300, 3, 0.0),
    (101, 303, 3, 0.01),     # every step over-counted
    (100, 301, 3, 1 / 300),  # one step of the window miscounted
    (100, 0, 0, 0.0),        # a window of no steps
])
def test_rays_gap_reads_the_first_step_and_the_window(step_rays, window_rays,
                                                      steps, gap):
    assert loop.rays_gap(step_rays, window_rays, steps, 100) == \
        pytest.approx(gap)


def test_the_control_fails_the_cells_limits():
    from port_bench import control
    assert control.VALUES["fit_frame"] is loop.control_values
    values = control.values(small_run())
    assert set(values) == set(harness.cell(CELL)["limits"])
    correct, _ = harness.judge(values, harness.cell(CELL)["limits"])
    assert not correct, values


def test_a_step_without_a_ray_total_fails_before_rendering(monkeypatch):
    real = inverse.make_train_step
    renders = []

    def bare(*a, **k):
        step, opt = real(*a, **k)
        return (lambda target: step(target)), opt

    monkeypatch.setattr(inverse, "make_train_step", bare)
    monkeypatch.setattr(inverse, "render_for_loss",
                        lambda *a, **k: renders.append(1))
    with pytest.raises(RuntimeError, match="ray total"):
        loop.run(small_run())
    assert renders == []


def fake_result(units=4):
    """A traced fit window of `units` steps: kernel A 2 s and kernel B
    0.5 s of device time over 4 launches each."""
    return {"steps": 10, "step_rays": 80_000_000,
            "shape": {"pixels": 921_600, "spp": 32, "max_bounces": 50,
                      "real": 484, "rows": 512},
            "trace": {"units": units, "busy_s": 3.0, "window_s": 4.0,
                      "ops": {"void oneshot_kernel<true>(float)": [2.0, 4],
                              "void backward_kernel<false, 51>(int)":
                                  [0.5, 4]}}}


def test_the_rooflines_read_their_counts():
    res = fake_result()
    p = roofline.peaks(harness.ROOT)
    peaks = {"hbm": p["hbm_bytes_per_s"], "fp32": p["fp32_ops_per_s"]}
    primary = 921_600 * 32
    a = 4 * (7 * 512 + primary * (7 + 4 + 51))
    a_ops = 80_000_000 * 484 * 16
    want_a = 100 * 4 * max(a / peaks["hbm"], a_ops / peaks["fp32"]) / 2.0
    b = 4 * (21 * 512 + primary * (10 + 51 + 6))
    want_b = 100 * 4 * max(b / peaks["hbm"],
                           80_000_000 * 270 / peaks["fp32"]) / 0.5
    got = harness.read_metrics(["oneshot_roofline.fit_frame",
                                "backward_roofline.fit_frame"], res)
    assert got["oneshot_roofline.fit_frame"]["value"] == pytest.approx(want_a)
    assert got["backward_roofline.fit_frame"]["value"] == pytest.approx(
        want_b)
    res.pop("step_rays")
    assert harness.read_metrics(["oneshot_roofline.fit_frame",
                                 "backward_roofline.fit_frame"], res) == {}


def test_idle_share_reads_the_traced_steps():
    got = harness.read_metrics(["idle_share.fit_frame"], fake_result())
    assert got["idle_share.fit_frame"]["value"] == pytest.approx(25.0)
    res = fake_result()
    res.pop("steps")
    assert harness.read_metrics(["idle_share.fit_frame"], res) == {}
    res = fake_result()
    res.pop("trace")
    assert harness.read_metrics(["idle_share.fit_frame"], res) == {}


class StreamSpan:
    """A closed device span with a given stream ms."""

    def __init__(self, name, ms):
        self.name, self.ms, self.end_ns = name, ms, 1

    @property
    def stream_ms(self):
        return self.ms


def test_raygen_ms_reads_stream_ms_per_traced_step(monkeypatch):
    mod = harness.load_module("metrics", "raygen_ms.fit_frame")
    st = profiling.Store()
    st.spans = [StreamSpan("raygen", ms) for ms in (7.5, 8.0, 8.25, 8.25)] \
        + [StreamSpan("kernel", 30.0)]
    st.frames = 9       # the reader divides by the traced steps, not these
    monkeypatch.setattr(profiling._REC, "store", st)
    assert mod.read(fake_result(units=4), harness.ROOT) == 8.0
    monkeypatch.setattr(profiling._REC, "store", profiling.Store())
    assert mod.read(fake_result(), harness.ROOT) is None
    monkeypatch.delattr(profiling, "spans")
    assert mod.read(fake_result(), harness.ROOT) is None


def test_the_loop_is_found_by_the_cells_name():
    cell = harness.cell(CELL)
    mod = importlib.import_module(
        f"port_bench.loops.{cell['traffic']['loop']}")
    assert mod is loop
    assert cell["config"]["render"] == {"width": 1280, "height": 720,
                                        "spp": 32, "max_bounces": 50}
    assert cell["config"]["reduced"] == [] and cell["chips"] == 1
