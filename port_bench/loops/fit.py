"""Window loop of the albedo fit on one card.

The loop users run (grad/inverse.fit_scene): one step of
grad/inverse.make_train_step with the mix's engine, then its loss read to
the host, then the next step. Set-up builds the one training step, with its
parameters and Adam's state, renders the target from the true albedos
through the same engine, and drives the step through its first
`checked_steps` steps (recording each loss, the first gradient as Adam's
state holds it, and the albedos after the last of them) and
`warmup_steps` more; the window then goes on with the same step.

After the window the plain reference (reference/fit.py) follows the first
steps from the same inputs, and three numbers judge them, as gaps of norms
per leaf (albedo_x, albedo_y, albedo_z) over the reference's norm of that
leaf or the median leaf's, whichever is larger:
loss_gap, the widest relative gap of a step's loss; grad_gap, of the first
gradient; change_gap, of the albedos' change over the checked steps. Leaves
whose reference gradient is under a thousandth of the median leaf's are left
out of the change.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import numpy as np
import torch

from port_bench.loops import common
from port_bench.reference import fit as ref_fit

BETA1 = 0.9


def start_albedo(cols, n_real, rng, lo, span):
    """(true, start) float32 (3, S): every real row's albedos times lo +
    span * uniform, clipped to [0, 1] (the recipe's perturbation, drawn from
    the seed)."""
    true = np.stack([cols[k] for k in ref_fit.LEAVES]).astype(np.float32)
    fac = (lo + span * rng.random(true.shape)).astype(np.float32)
    fac[:, n_real:] = 1.0
    return true, np.clip(true * fac, 0.0, 1.0).astype(np.float32)


def norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """Widest gap between the program's and the reference's norms of a
    leaf, over the larger of the reference's norm of it and of the median
    leaf. keep: the leaves compared (default all)."""
    keep = list(keep or ref)
    rn = {k: float(ref[k].norm()) for k in ref}
    med = statistics.median(rn.values())
    return max(abs(float(prog[k].float().cpu().norm()) - rn[k])
               / max(rn[k], med) for k in keep)


def judge_fit(prog, refr) -> dict:
    g = {k: v.cpu() for k, v in refr["grad1"].items()}
    med = statistics.median(float(v.norm()) for v in g.values())
    moved = [k for k, v in g.items() if float(v.norm()) >= 1e-3 * med]
    change_ref = {k: (refr["params"][k] - refr["start"][k]).cpu() for k in g}
    change_prog = {k: prog["params"][k] - prog["start"][k] for k in g}
    loss_gap = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                   for a, b in zip(prog["losses"], refr["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": norm_gap(prog["grad1"], g),
            "change_gap": norm_gap(change_prog, change_ref, moved)}


def run(run: common.Run) -> dict:
    from rays1bench_tpu_torch.core.config import RenderConfig
    from rays1bench_tpu_torch.grad.inverse import (InverseConfig,
                                                   make_train_step,
                                                   params_of, render_for_loss)
    dev = run.device
    traffic = run.cell["traffic"]
    r = common.settings(run)
    cols, n_real, cam_spec, seed, rng = common.inputs(run)
    true, start = start_albedo(cols, n_real, rng, *traffic["perturb"])
    soa, camera = common.program_scene(cols, cam_spec, r, dev)
    cfg = RenderConfig(width=r["width"], height=r["height"], spp=r["spp"],
                       max_bounces=r["max_bounces"], seed=seed,
                       early_exit=False)
    engine = traffic["engine"]
    with torch.no_grad():
        target = render_for_loss(soa, camera, cfg, engine=engine)
    begin = dataclasses.replace(soa, **{
        k: torch.from_numpy(start[i].copy()).to(dev)
        for i, k in enumerate(ref_fit.LEAVES)})
    inv = InverseConfig(learning_rate=traffic["lr"], optimize=ref_fit.LEAVES)
    params = params_of(begin, ref_fit.LEAVES)
    step, optimizer = make_train_step(begin, camera, cfg, inv, params,
                                      engine=engine)
    prog = {"losses": [], "start": {k: torch.from_numpy(start[i].copy())
                                    for i, k in enumerate(ref_fit.LEAVES)}}
    for i in range(common.traffic(run, "checked_steps")):
        prog["losses"].append(float(step(target)))
        if i == 0:
            prog["grad1"] = {
                k: (optimizer.state[p]["exp_avg"] / (1 - BETA1)).cpu()
                for k, p in params.items()}
    prog["params"] = {k: p.detach().cpu().clone() for k, p in params.items()}
    for _ in range(traffic["warmup_steps"]):
        float(step(target))
    common.sync(dev)
    setup_s = time.perf_counter() - run.t_start
    losses = []
    with common.window(run) as win:
        while win.elapsed() < run.seconds:
            losses.append(float(step(target)))
            win.tick()
    peak = common.memory_peak(dev)
    summary = win.summary()
    del step, optimizer, params, target, soa, begin, camera
    common.free(dev)
    t_ref = time.perf_counter()
    refr = ref_fit.fit_reference(
        cols, true, start, cam_spec, r["width"], r["height"], r["spp"], seed,
        r["max_bounces"], traffic["lr"], len(prog["losses"]), dev)
    reference_s = time.perf_counter() - t_ref
    failed = sum(not math.isfinite(x) for x in losses)
    return common.finish(
        judge_fit(prog, refr), run.cell["limits"], setup_s=setup_s,
        window_s=win.seconds, steps=len(losses), attempted=len(losses),
        failed=failed, memory_peak_bytes=peak, trace=summary,
        step_rays=refr["rays"], reference_s=reference_s,
        shape={"pixels": r["width"] * r["height"], "spp": r["spp"],
               "max_bounces": r["max_bounces"], "real": n_real,
               "rows": len(cols["radius"])})
