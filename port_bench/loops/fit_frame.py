"""Window loop of the albedo fit at the reference's frame, on one card.

loops/fit.py's loop, at a size whose whole-frame rows reference/fit.py
cannot hold: one step of grad/inverse.make_train_step with the mix's
engine, then its loss read to the host, then the next step. Set-up builds
the step, renders the target from the true albedos through the same
engine, and drives the step through its first `checked_steps` steps and
`warmup_steps` more. What differs from loops/fit.py:

- the rays are the program's own: each step's int64 ray total (step.rays,
  kernel A's count), summed on the card over the window and read to the
  host once, at its end; step_rays is the first step's, read in set-up;
- the first steps are judged against reference/fit_frame.py, the same fit
  computed in blocks of whole pixels, by loops/fit.py's loss_gap, grad_gap
  and change_gap;
- the rays are judged too, by rays_gap: the first step's count against
  the reference's, and the window's sum against its steps times the
  reference's (every step traces the same paths: the albedos change only
  what a path carries, not where it goes).

A program whose step keeps no ray total cannot run this cell: the loop
raises before the target is rendered.

calibrate.py and the tests look a loop's control and faults up by the
loop's name; importing this module adds them under "fit_frame" (the
control: reference/fit_frame.py in bfloat16 against the same in float32;
the faults: faults.py's fit faults, which this loop's step runs through,
and "count", a step that counts 1% more rays than it traced).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from unittest import mock

import torch

from port_bench import control, faults
from port_bench.loops import common
from port_bench.loops import fit as fit_loop
from port_bench.reference import fit as ref_fit
from port_bench.reference import fit_frame as ref_frame


def reference(run: common.Run, cols, true, start, cam_spec, r, seed,
              steps, dtype=torch.float32) -> dict:
    return ref_frame.fit_reference(
        cols, true, start, cam_spec, r["width"], r["height"], r["spp"], seed,
        r["max_bounces"], run.cell["traffic"]["lr"], steps, run.device,
        dtype)


def rays_gap(step_rays: int, window_rays: int, steps: int,
             reference_rays: int) -> float:
    """The wider of the first step's count against the reference's and the
    window's sum against steps times the reference's, each as a share of
    the latter."""
    window_want = steps * reference_rays
    return max(abs(step_rays - reference_rays) / reference_rays,
               abs(window_rays - window_want) / max(window_want, 1))


def control_values(run: common.Run) -> dict:
    """The control's readings: the reference's checked steps in bfloat16
    judged against the same in float32, its count of one step standing for
    the window's one step."""
    r = common.settings(run)
    cols, n_real, cam_spec, seed, rng = common.inputs(run)
    true, start = fit_loop.start_albedo(cols, n_real, rng,
                                        *run.cell["traffic"]["perturb"])
    steps = common.traffic(run, "checked_steps")
    args = (run, cols, true, start, cam_spec, r, seed, steps)
    low, high = reference(*args, dtype=control.LOW), reference(*args)
    return dict(fit_loop.judge_fit(low, high),
                rays_gap=rays_gap(low["rays"], low["rays"], 1, high["rays"]))


@contextlib.contextmanager
def fit_frame_fault(fault: str):
    """faults.py's fit faults, and "count": every render of the step
    reports 1% more rays than it traced."""
    if fault != "count":
        with faults.fit_fault(fault):
            yield
        return
    from rays1bench_tpu_torch.grad import inverse
    real = inverse.render_for_loss

    def over(*a, with_total=False, **k):
        if not with_total:
            return real(*a, **k)
        img, total = real(*a, with_total=True, **k)
        return img, total + total // 100

    with mock.patch.object(inverse, "render_for_loss", over):
        yield


FAULTS = faults.FIT + ("count",)
control.VALUES.setdefault("fit_frame", control_values)
faults.FAULTS.setdefault("fit_frame", (fit_frame_fault, FAULTS))


def run(run: common.Run) -> dict:
    from rays1bench_tpu_torch.core.config import RenderConfig
    from rays1bench_tpu_torch.grad.inverse import (InverseConfig,
                                                   make_train_step,
                                                   params_of, render_for_loss)
    dev = run.device
    traffic = run.cell["traffic"]
    r = common.settings(run)
    cols, n_real, cam_spec, seed, rng = common.inputs(run)
    true, start = fit_loop.start_albedo(cols, n_real, rng,
                                        *traffic["perturb"])
    soa, camera = common.program_scene(cols, cam_spec, r, dev)
    cfg = RenderConfig(width=r["width"], height=r["height"], spp=r["spp"],
                       max_bounces=r["max_bounces"], seed=seed,
                       early_exit=False)
    engine = traffic["engine"]
    begin = dataclasses.replace(soa, **{
        k: torch.from_numpy(start[i].copy()).to(dev)
        for i, k in enumerate(ref_fit.LEAVES)})
    inv = InverseConfig(learning_rate=traffic["lr"], optimize=ref_fit.LEAVES)
    params = params_of(begin, ref_fit.LEAVES)
    step, optimizer = make_train_step(begin, camera, cfg, inv, params,
                                      engine=engine)
    if not hasattr(step, "rays"):
        raise RuntimeError("the program's training step keeps no ray total "
                           "(step.rays): this cell cannot count its rays")
    with torch.no_grad():
        target = render_for_loss(soa, camera, cfg, engine=engine)
    prog = {"losses": [], "start": {k: torch.from_numpy(start[i].copy())
                                    for i, k in enumerate(ref_fit.LEAVES)}}
    for i in range(common.traffic(run, "checked_steps")):
        prog["losses"].append(float(step(target)))
        if i == 0:
            step_rays = int(step.rays)
            prog["grad1"] = {
                k: (optimizer.state[p]["exp_avg"] / (1 - fit_loop.BETA1))
                .cpu() for k, p in params.items()}
    prog["params"] = {k: p.detach().cpu().clone() for k, p in params.items()}
    for _ in range(traffic["warmup_steps"]):
        float(step(target))
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    common.sync(dev)
    setup_s = time.perf_counter() - run.t_start
    losses = []
    with common.window(run) as win:
        while win.elapsed() < run.seconds:
            loss = step(target)
            rays += step.rays
            losses.append(float(loss))
            win.tick()
    window_rays = int(rays)
    peak = common.memory_peak(dev)
    summary = win.summary()
    del step, optimizer, params, target, soa, begin, camera, loss, rays
    common.free(dev)
    t_ref = time.perf_counter()
    refr = reference(run, cols, true, start, cam_spec, r, seed,
                     len(prog["losses"]))
    reference_s = time.perf_counter() - t_ref
    failed = sum(not math.isfinite(x) for x in losses)
    values = dict(fit_loop.judge_fit(prog, refr),
                  rays_gap=rays_gap(step_rays, window_rays, len(losses),
                                    refr["rays"]))
    return common.finish(
        values, run.cell["limits"], setup_s=setup_s,
        window_s=win.seconds, steps=len(losses), attempted=len(losses),
        failed=failed, rays=window_rays, step_rays=step_rays,
        reference_rays=refr["rays"], memory_peak_bytes=peak, trace=summary,
        reference_s=reference_s,
        shape={"pixels": r["width"] * r["height"], "spp": r["spp"],
               "max_bounces": r["max_bounces"], "real": n_real,
               "rows": len(cols["radius"])})
