"""The control of each check: the plain reference put in the program's place
and computed in bfloat16, the nearest precision below the float32 the
configurations state. Its readings are the numbers the check computes when
the control's output stands where the program's would. A check whose limit
the control does not fail on some number could not tell a lower precision
from the program, and has no upper reading.

Renders: the control renders the sampled pixels and traces the sampled
paths in bfloat16; its frame count is what those paths estimate, read
against the float32 estimate, since a whole frame in plain torch takes
minutes. The fit: the reference's three steps in bfloat16 against the same
in float32.
"""

from __future__ import annotations

import torch

from port_bench.loops import common
from port_bench.loops import fit as fit_loop
from port_bench.reference import fit as ref_fit
from port_bench.reference import render as ref

LOW = torch.bfloat16


def render_values(run: common.Run) -> dict:
    r = common.settings(run)
    cols, _, cam_spec, seed, rng = common.inputs(run)
    pixels, paths = common.check_draws(run, r, rng)
    respawn = run.cell["traffic"]["engine"] == "respawn"
    args = (cols, cam_spec, pixels, r["width"], r["height"], r["spp"], seed,
            r["max_bounces"], run.device)
    img, _ = ref.render_pixels(*args, torch.float32, respawn)
    low, _ = ref.render_pixels(*args, LOW, respawn)
    est = [common.estimate_rays(cols, cam_spec, paths, r, seed, run.device,
                                dtype) for dtype in (torch.float32, LOW)]
    return {"pixel_gap": float((low - img).abs().max()),
            "rays_gap": abs(est[1] - est[0]) / est[0],
            "frames_differ": 0}


def fit_values(run: common.Run) -> dict:
    traffic = run.cell["traffic"]
    r = common.settings(run)
    cols, n_real, cam_spec, seed, rng = common.inputs(run)
    true, start = fit_loop.start_albedo(cols, n_real, rng,
                                        *traffic["perturb"])
    steps = common.traffic(run, "checked_steps")
    args = (cols, true, start, cam_spec, r["width"], r["height"], r["spp"],
            seed, r["max_bounces"], traffic["lr"], steps, run.device)
    high = ref_fit.fit_reference(*args)
    low = ref_fit.fit_reference(*args, dtype=LOW)
    return fit_loop.judge_fit(low, high)


VALUES = {"render": render_values, "sharded": render_values,
          "fit": fit_values}


def values(run: common.Run) -> dict:
    return VALUES[run.cell["traffic"]["loop"]](run)
