"""Window loop of the renders on one card.

Frames of kernels/pipeline.render_image_megakernel, the program's entry,
with the mix's engine ("respawn": the respawn kernel; "oneshot": raygen in
torch, the one-shot kernel and the spp mean; "wavefront": the same with the
phase kernel over the mix's `schedule` of bounces per phase). A closed
loop: the next frame is issued as soon as fewer than `in_flight` frames are
queued, so
in_flight 1 synchronises every frame (an interactive preview) and 2 keeps
the card fed back to back (the reference's benchmark). Every frame renders
the same inputs; each frame's ray count stays on the card until the window
has closed.

After the window the last frame is judged against the plain reference on a
pixel drawn from the seed in every tile of `check_tile`, with all its
samples, and its ray count against the count of `count_paths_per_pixel`
paths drawn from each pixel's samples; every frame's count must equal the
last's.
"""

from __future__ import annotations

import time

import torch

from port_bench.loops import common


def run(run: common.Run) -> dict:
    from rays1bench_tpu_torch.core.config import RenderConfig
    from rays1bench_tpu_torch.kernels.pipeline import render_image_megakernel
    dev = run.device
    r = common.settings(run)
    cols, n_real, cam_spec, seed, rng = common.inputs(run)
    draws = common.check_draws(run, r, rng)
    engine = run.cell["traffic"]["engine"]
    respawn = engine == "respawn"
    wavefront = (tuple(run.cell["traffic"]["schedule"])
                 if engine == "wavefront" else None)
    soa, camera = common.program_scene(cols, cam_spec, r, dev)
    cfg = RenderConfig(width=r["width"], height=r["height"], spp=r["spp"],
                       max_bounces=r["max_bounces"], seed=seed)

    def frame():
        return render_image_megakernel(soa, camera, cfg, n_real=n_real,
                                       respawn=respawn, wavefront=wavefront)

    for _ in range(run.cell["traffic"]["warmup_frames"]):
        frame()
    common.sync(dev)
    setup_s = time.perf_counter() - run.t_start
    with common.window(run) as win:
        image, counts = common.closed_loop(
            frame, run.cell["traffic"]["in_flight"], dev, win,
            lambda _: win.elapsed() >= run.seconds)
    counts = torch.stack(counts).cpu()
    image = image.float().cpu()
    peak = common.memory_peak(dev)
    summary = win.summary()
    del soa, camera
    common.free(dev)
    differ = int((counts != counts[-1]).sum())
    t_ref = time.perf_counter()
    values = common.frame_check(image, int(counts[-1]), cols, cam_spec,
                                draws, r, seed, respawn, dev)
    values["frames_differ"] = differ
    reference_s = time.perf_counter() - t_ref
    return common.finish(
        values, run.cell["limits"], setup_s=setup_s, window_s=win.seconds,
        frames=len(counts), rays=int(counts.sum()),
        frame_rays=int(counts[-1]), attempted=len(counts), failed=differ,
        reference_s=reference_s,
        memory_peak_bytes=peak, trace=summary,
        shape={"pixels": r["width"] * r["height"], "spp": r["spp"],
               "max_bounces": r["max_bounces"], "real": n_real,
               "rows": len(cols["radius"])})
