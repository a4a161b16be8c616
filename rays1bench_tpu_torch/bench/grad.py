"""Sustained gradient steps on one CUDA GPU (the port's tools/grad_bench.py).

    python -m rays1bench_tpu_torch.bench.grad --scene medium
        [--engine mega|pipeline] [--steps N] [--soft EPS]

One step is grad.inverse.make_train_step's: raygen, the topology kernel
forward, the loss, the fused backward kernel with autograd's chain onto the
scene, and one Adam step (engine "mega"); or, with --engine pipeline, the
plain fixed-trip renderer with the closest-hit index kernel as its sweep,
autograd over every bounce (checkpointed per bounce when the frame has
more than one chunk), and Adam. The fit is the medium-fit recipe
(tools/medium_fit_probe.py): every albedo column, lr 1e-2, from the
perturbation of perturb_albedos back to the scene's own render, so the loss
is non-zero and falls and the geometry, and with it the rays traced a step,
stays fixed. (tools/grad_bench.py fits its default columns from the
unperturbed scene, at loss 0.) max_bounces is 10, as in tools/grad_bench.py.

--soft EPS (> 0) takes the geometry recipe through the soft-silhouette
renderer at cfg.soft_silhouette = EPS, whose step renders twice for the
U-statistic loss (two launches of each kernel): on the small scene the
full-resolution geometry fit (tools/fullres_fit_probe.py:55-75: seed 3,
row 0 moved by center_x +0.06, center_y -0.04, radius -0.03; center_x,
center_y and radius of every row, lr 2e-3); on the medium scene the second
stage of tools/medium_fit_probe.py:64-102 (seed 5, center_x of row 1 +0.05
and center_y of row 2 +0.04; the centers of rows 1 and 2, lr 2e-3; the
probe's band is 0.005 * 1280 / width). The albedos start true, where the
probe's stage 2 starts from its stage-1 fit. The target is the unmoved
scene's soft render through the same engine.
After WARMUP untimed steps, --steps steps run back to back between two CUDA
events. Then, each measured once more:
  - one step split into its phases by the stream ms of the spans the
    step itself records (make_train_step's, in utils/profiling.session(),
    a host-only torch.profiler session that turns the recorder on):
    forward (raygen, the topology kernel, the image), loss, backward (the
    fused kernel and autograd's chain onto the scene and camera tensors),
    Adam, and that profiled step's own total ("step"). The session's host
    cost stretches a host-paced step, so the split is of the profiled step
    and not of s_per_step: phase_share gives each phase as a share of the
    profiled step's total;
  - each mega kernel alone on the last step's inputs (launch_ms: median of
    3 launches, each timed alone behind a device-side wait, with the host's
    time to issue it), engine "mega" only;
  - PROFILED_STEPS steps under torch.profiler: device busy time (the union
    of the device events), each kernel's share of it, the device functions
    that took longest, the count of device events, and the idle share
    1 - busy / wall.
Prints one JSON line with the workload, s_per_step, steps_per_sec, losses,
these splits, the rays traced per step, and the card's name and power limit.
Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time

import numpy as np
import torch

from rays1bench_tpu_torch.bench.profile import smi
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad.inverse import (InverseConfig, make_train_step,
                                               params_of, render_for_loss,
                                               with_params)
from rays1bench_tpu_torch.kernels import mega_backward
from rays1bench_tpu_torch.kernels.megakernel import (pack_spheres,
                                                     trace_topology)
from rays1bench_tpu_torch.kernels.pipeline import frame_ray_ids
from rays1bench_tpu_torch.render.pipeline import primary_rays_from_ids
from rays1bench_tpu_torch.scene import builders
from rays1bench_tpu_torch.scene.spheres import prepare
from rays1bench_tpu_torch.utils import profiling

# The port's kernels by the name of their __global__ function (is_kernel).
KERNELS = {"oneshot": "oneshot_kernel", "mega_backward": "backward_kernel",
           "intersect_index": "index_kernel"}
TOP_KERNELS = 5
PHASES = ("forward", "loss", "backward", "adam")
PROFILED_STEPS = {"mega": 3, "pipeline": 1}
ALBEDOS = ("albedo_x", "albedo_y", "albedo_z")
# The geometry recipes of --soft: (seed, {column: {row: offset}}, optimized
# columns, rows or None for all).
GEOMETRY = {
    "small": (3, {"center_x": {0: 0.06}, "center_y": {0: -0.04},
                  "radius": {0: -0.03}},
              ("center_x", "center_y", "radius"), None),
    "medium": (5, {"center_x": {1: 0.05}, "center_y": {2: 0.04}},
               ("center_x", "center_y"), (1, 2)),
}
GEOMETRY_LR = 2e-3
MAX_BOUNCES = 10
WARMUP = 2
# Device-side wait ahead of a timed launch: 2e7 cycles, ~10 ms at the H100's
# 1.98 GHz boost clock, ample for the host to issue a kernel.
WAIT_CYCLES = 20_000_000


def perturb_albedos(soa, n_real):
    """Every real row's albedos times 0.6 + 0.9 * rand from RandomState(11),
    clipped to [0, 1] (examples/inverse_rendering.py:95-103)."""
    fac = 0.6 + 0.9 * np.random.RandomState(11).rand(3, soa.count)
    fac[:, n_real:] = 1.0
    fac = torch.from_numpy(fac.astype(np.float32)).to(soa.albedo_x.device)
    return dataclasses.replace(soa, **{
        c: torch.clamp(getattr(soa, c) * fac[k], 0.0, 1.0)
        for k, c in enumerate(ALBEDOS)})


def moved_geometry(soa, scene_name):
    """The geometry recipe's start: the scene with its rows moved."""
    _, moves, _, _ = GEOMETRY[scene_name]
    cols = {}
    for c, by_row in moves.items():
        col = getattr(soa, c).clone()
        for row, offset in by_row.items():
            col[row] += offset
        cols[c] = col
    return dataclasses.replace(soa, **cols)


def geometry_config(scene_name, steps=8) -> InverseConfig:
    _, _, optimize, rows = GEOMETRY[scene_name]
    return InverseConfig(learning_rate=GEOMETRY_LR, steps=steps,
                         optimize=optimize, rows=rows)


def is_kernel(event_name: str, function: str) -> bool:
    """Is a profiler device event a launch of the port's __global__
    `function`: its name holds "::<function>(", or "::<function><" for the
    hard and soft instantiations of a template. torch's own kernels, such as
    indexing_backward_kernel, do not match."""
    return f"::{function}(" in event_name or f"::{function}<" in event_name


def cuda_ms(fn, reps=1):
    """(last result, mean ms of fn() over reps calls between CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def launch_ms(fn, reps=3):
    """(last result, median device ms, [device ms], [host ms]) of reps calls
    of fn, each alone: the device idle, the previous result freed (so the
    allocator hands the same blocks back), then a device-side wait of
    WAIT_CYCLES queued ahead of the two events, so that the host's time to
    issue fn (host ms) does not count as device time unless it outlasts the
    wait."""
    device, host, out = [], [], None
    for _ in range(reps):
        out = None
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(WAIT_CYCLES)
        start.record()
        t0 = time.perf_counter()
        out = fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    return out, float(np.median(device)), device, host


def kernel_ms(spheres, camera, cfg):
    """({kernel: median ms}, {kernel: {"device": [ms], "host": [ms]}}, rays
    the forward traces) of the two gradient kernels alone on these
    inputs."""
    with torch.no_grad():
        prep = prepare(spheres)
        ray_id = frame_ray_ids(cfg, spheres.center_x.device)
        rays = [r.contiguous() for r in primary_rays_from_ids(
            camera, cfg, ray_id)]
        packed = pack_spheres(prep)
        fwd = lambda: trace_topology(packed, *rays, ray_id, cfg)
        fwd()
        (_, _, total, topo), fwd_ms, fwd_dev, fwd_host = launch_ms(fwd)
        ct = torch.full_like(rays[0], 1.0 / cfg.num_primary_rays)
        bwd = lambda: mega_backward.backward(prep, *rays, ray_id, ct, ct, ct,
                                             topo, cfg)
        bwd()
        _, bwd_ms, bwd_dev, bwd_host = launch_ms(bwd)
    return ({"oneshot": fwd_ms, "mega_backward": bwd_ms},
            {"oneshot": {"device": fwd_dev, "host": fwd_host},
             "mega_backward": {"device": bwd_dev, "host": bwd_host}},
            int(total))


def phase_ms(step, target):
    """One step of make_train_step's under profiling.session(), split into
    its phases by the stream ms of the spans it records: {phase: ms}, and
    "step" the profiled step's own total."""
    with profiling.session():
        step(target)
    torch.cuda.synchronize()
    return {n: profiling.spans(n)[0].stream_ms for n in PHASES + ("step",)}


def device_split(step, target, steps=3):
    """torch.profiler over `steps` steps: (wall ms, device busy ms,
    {kernel: device ms}, [[name, device ms], ...] of the TOP_KERNELS
    device functions that took longest, names cut at 80 characters, count
    of device events) or None where the profiler saw no device event."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(target)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    span = lambda es: profiling.busy_us(
        (e.time_range.start, e.time_range.end) for e in es) / 1e3
    by_name = collections.defaultdict(float)
    for e in dev:
        by_name[e.name[:80]] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return wall, span(dev), {
        k: span(e for e in dev if is_kernel(e.name, name))
        for k, name in KERNELS.items()}, [list(kv) for kv in top], len(dev)


def run(scene_name, cfg, steps=8, engine="mega"):
    """The measurements above for one scene and config, as a dict."""
    # Tight padding: the topology forward sweeps every row. The large
    # scene's 484 spheres pad to 512 rows, as in tools/grad_bench.py.
    pad = 128 if scene_name == "large" else 8
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=pad,
                                        device="cuda")
    camera = scene.camera.build("cuda")
    with torch.no_grad():
        target = render_for_loss(scene.spheres, camera, cfg, engine=engine)
    if cfg.soft_silhouette:
        start = moved_geometry(scene.spheres, scene_name)
        inv = geometry_config(scene_name)
    else:
        start = perturb_albedos(scene.spheres, scene.n_real)
        inv = InverseConfig(learning_rate=1e-2, optimize=ALBEDOS)
    params = params_of(start, inv.optimize)
    step, _ = make_train_step(start, camera, cfg, inv, params, engine=engine)
    for _ in range(WARMUP):
        step(target)
    losses, ms = cuda_ms(lambda: [step(target) for _ in range(steps)])
    per_step = ms / 1e3 / steps
    phases = phase_ms(step, target)
    kernels = launches = rays = None
    if engine == "mega":
        kernels, launches, rays = kernel_ms(with_params(start, params),
                                            camera, cfg)
    split = device_split(step, target, PROFILED_STEPS[engine])
    out = {
        "scene": scene_name, "engine": engine, "rows": scene.spheres.count,
        "recipe": "geometry" if cfg.soft_silhouette else "albedo",
        "soft_silhouette": cfg.soft_silhouette, "seed": cfg.seed,
        "width": cfg.width, "height": cfg.height, "spp": cfg.spp,
        "max_bounces": cfg.max_bounces, "steps": steps,
        "s_per_step": per_step, "steps_per_sec": 1.0 / per_step,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "phase_ms": phases,
        "phase_share": {n: phases[n] / phases["step"] for n in PHASES},
        "kernel_ms": kernels,
        "kernel_launch_ms": launches, "rays_per_step": rays,
        "profiled_steps": None}
    if split is not None:
        wall, busy, by_kernel, top, events = split
        out["profiled_steps"] = {"steps": PROFILED_STEPS[engine],
                                 "wall_ms": wall,
                                 "device_busy_ms": busy,
                                 "kernel_device_ms": by_kernel,
                                 "top_device_ms": top,
                                 "device_events": events,
                                 "idle_share": 1.0 - busy / wall}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="medium",
                    choices=["small", "medium", "large"])
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--engine", default="mega", choices=["mega", "pipeline"])
    ap.add_argument("--soft", type=float, default=0.0,
                    help="soft_silhouette width: the geometry recipe "
                         "(small or medium scene)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rays1bench_tpu_torch.bench.grad needs a CUDA "
                         "device")
    seed = RenderConfig.seed
    if args.soft:
        if args.scene not in GEOMETRY:
            raise SystemExit(f"--soft has geometry recipes for "
                             f"{sorted(GEOMETRY)}, not {args.scene!r}")
        seed = GEOMETRY[args.scene][0]
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_bounces=MAX_BOUNCES, early_exit=False, seed=seed,
                       soft_silhouette=args.soft)
    out = run(args.scene, cfg, args.steps, args.engine)
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = smi("name", "power.limit")[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
