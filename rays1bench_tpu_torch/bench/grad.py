"""Sustained gradient steps on one CUDA GPU (the port's tools/grad_bench.py).

    python -m rays1bench_tpu_torch.bench.grad --scene medium

One step is grad.inverse.make_train_step's: raygen, the topology kernel
forward, the loss, the fused backward kernel with autograd's chain onto the
scene, and one Adam step. The fit is the medium-fit recipe
(tools/medium_fit_probe.py): every albedo column, lr 1e-2, from the
perturbation of perturb_albedos back to the scene's own render, so the loss
is non-zero and falls and the geometry, and with it the rays traced a step,
stays fixed. (tools/grad_bench.py fits its default columns from the
unperturbed scene, at loss 0.) max_bounces is 10, as in tools/grad_bench.py.
After WARMUP untimed steps, --steps steps run back to back between two CUDA
events. Then, each measured once more:
  - one step split at its phase boundaries by CUDA events that the step
    itself records (make_train_step's mark): forward (raygen, the topology
    kernel, the image), loss, backward (the fused kernel and autograd's
    chain onto the scene and camera tensors), Adam;
  - each kernel alone on the last step's inputs (launch_ms: median of 3
    launches, each timed alone behind a device-side wait, with the host's
    time to issue it);
  - three steps under torch.profiler: device busy time (the union of the
    device events), the two kernels' share of it, and the idle share
    1 - busy / wall.
Prints one JSON line with the workload, s_per_step, steps_per_sec, losses,
these splits, the rays traced per step, and the card's name and power limit.
Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from rays1bench_tpu_torch.bench.profile import busy_us, smi
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad.inverse import (InverseConfig, make_train_step,
                                               params_of, render_for_loss,
                                               with_params)
from rays1bench_tpu_torch.kernels import mega_backward
from rays1bench_tpu_torch.kernels.megakernel import (pack_spheres,
                                                     trace_topology)
from rays1bench_tpu_torch.kernels.pipeline import ray_coords
from rays1bench_tpu_torch.render.pipeline import primary_rays
from rays1bench_tpu_torch.scene import builders
from rays1bench_tpu_torch.scene.spheres import prepare

KERNELS = {"oneshot": "oneshot_kernel", "mega_backward": "backward_kernel"}
ALBEDOS = ("albedo_x", "albedo_y", "albedo_z")
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
        ray_id, x, y = ray_coords(cfg, spheres.center_x.device)
        rays = [r.contiguous() for r in primary_rays(camera, cfg, x, y,
                                                     ray_id)]
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
    """One step of make_train_step's, split into its phases by the CUDA
    events it records at its marks: {phase: ms}."""
    marks = []

    def mark():
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    step(target, mark)
    marks[-1].synchronize()
    names = ("forward", "loss", "backward", "adam")
    return {n: a.elapsed_time(b) for n, a, b in zip(names, marks, marks[1:])}


def device_split(step, target, steps=3):
    """torch.profiler over `steps` steps: (wall ms, device busy ms,
    {kernel: device ms}) or None where the profiler saw no device event."""
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
    span = lambda es: busy_us((e.time_range.start, e.time_range.end)
                              for e in es) / 1e3
    return wall, span(dev), {k: span(e for e in dev if name in e.name)
                             for k, name in KERNELS.items()}


def run(scene_name, cfg, steps=8):
    """The measurements above for one scene and config, as a dict."""
    # Tight padding: the topology forward sweeps every row. The large
    # scene's 484 spheres pad to 512 rows, as in tools/grad_bench.py.
    pad = 128 if scene_name == "large" else 8
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=pad,
                                        device="cuda")
    camera = scene.camera.build("cuda")
    with torch.no_grad():
        target = render_for_loss(scene.spheres, camera, cfg)
    start = perturb_albedos(scene.spheres, scene.n_real)
    inv = InverseConfig(learning_rate=1e-2, optimize=ALBEDOS)
    params = params_of(start, inv.optimize)
    step, _ = make_train_step(start, camera, cfg, inv, params)
    for _ in range(WARMUP):
        step(target)
    losses, ms = cuda_ms(lambda: [step(target) for _ in range(steps)])
    per_step = ms / 1e3 / steps
    phases = phase_ms(step, target)
    kernels, launches, rays = kernel_ms(with_params(start, params), camera,
                                        cfg)
    split = device_split(step, target)
    out = {
        "scene": scene_name, "rows": scene.spheres.count,
        "width": cfg.width, "height": cfg.height, "spp": cfg.spp,
        "max_bounces": cfg.max_bounces, "steps": steps,
        "s_per_step": per_step, "steps_per_sec": 1.0 / per_step,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "phase_ms": phases, "kernel_ms": kernels,
        "kernel_launch_ms": launches, "rays_per_step": rays,
        "profiled_steps": None}
    if split is not None:
        wall, busy, by_kernel = split
        out["profiled_steps"] = {"steps": 3, "wall_ms": wall,
                                 "device_busy_ms": busy,
                                 "kernel_device_ms": by_kernel,
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rays1bench_tpu_torch.bench.grad needs a CUDA "
                         "device")
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_bounces=MAX_BOUNCES, early_exit=False)
    out = run(args.scene, cfg, args.steps)
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = smi("name", "power.limit")[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
