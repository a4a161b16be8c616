"""Where a frame's time goes, on one CUDA GPU.

    python -m rays1bench_tpu_torch.bench.profile

Every frame is 1280x720 @ 50 bounces through render_image_megakernel, at
250 spp (the giant scene at 16 spp, since one of its frames at 250 spp takes
half a minute). For the large scene, the headline, it first prints
  - host prep: prepare_trimmed and the packing, wall ms between two device
    synchronizations (median of 5);
  - one frame under torch.profiler: its wall ms, the device's busy ms (the
    union of all device events), the respawn kernel's device ms, and the
    idle share 1 - busy / wall.
Then for the large, medium, small and giant scenes, three frames each timed
with CUDA events (rays, ms and mrays/s), while nvidia-smi samples the power
draw and the SM clock every 100 ms (median and max over the samples). The
first line names the card and its power limit.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels.megakernel import pack_camera, pack_spheres
from rays1bench_tpu_torch.kernels.pipeline import (prepare_trimmed,
                                                   render_image_megakernel)
from rays1bench_tpu_torch.scene import builders

SCENES = ("large", "medium", "small", "giant")
FRAMES = 3


def smi(*query: str) -> list:
    out = subprocess.run(["nvidia-smi", "--query-gpu=" + ",".join(query),
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def host_prep_ms(scene) -> float:
    def prep():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pack_spheres(prepare_trimmed(scene.spheres, scene.n_real))
        pack_camera(scene.camera.build("cuda"))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    prep()
    return statistics.median(prep() for _ in range(5))


def profiled_frame(scene, cfg):
    """(wall ms, device busy ms or None, kernel device ms or None) of one
    frame under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    camera = scene.camera.build("cuda")
    render = lambda: render_image_megakernel(scene.spheres, camera, cfg,
                                             n_real=scene.n_real)
    render()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return wall, None, None
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3
    kernel = busy_us((e.time_range.start, e.time_range.end) for e in dev
                      if "respawn_kernel" in e.name) / 1e3
    return wall, busy, kernel


def timed_frames(scene, cfg, frames):
    """[(rays, ms)] for `frames` frames, each between CUDA events, and the
    nvidia-smi samples [(watts, MHz)] taken while they ran."""
    camera = scene.camera.build("cuda")
    render = lambda: render_image_megakernel(scene.spheres, camera, cfg,
                                             n_real=scene.n_real)
    render()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=power.draw,clocks.sm",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                           text=True)
    try:
        out = []
        for _ in range(frames):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, rays = render()
            end.record()
            end.synchronize()
            out.append((int(rays), start.elapsed_time(end)))
    finally:
        smi.terminate()
        text, _ = smi.communicate(timeout=30)
    samples = []
    for line in text.splitlines():
        parts = [p.strip() for p in line.split(",")]
        try:
            samples.append((float(parts[0]), float(parts[1])))
        except (ValueError, IndexError):
            continue
    return out, samples


def main():
    if not torch.cuda.is_available():
        raise SystemExit("rays1bench_tpu_torch.bench.profile needs a CUDA "
                         "device")
    print(f"[card] {smi('name', 'power.limit')[0]} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    for name in SCENES:
        spp = 16 if name == "giant" else 250
        cfg = RenderConfig(width=1280, height=720, spp=spp, max_bounces=50)
        scene = builders.SCENES[name](cfg.aspect, device="cuda")
        label = f"{name} 1280x720 @ {spp} spp @ 50 b"
        if name == "large":
            print(f"[prep] {label}: host prep {host_prep_ms(scene):.3f} "
                  f"ms (median of 5)", flush=True)
            wall, busy, kernel = profiled_frame(scene, cfg)
            if busy is None:
                print(f"[profile] {label}: wall {wall:.1f} ms; device time "
                      f"not measured (the profiler recorded no device "
                      f"events)", flush=True)
            else:
                print(f"[profile] {label}: wall {wall:.1f} ms, device busy "
                      f"{busy:.1f} ms, respawn kernel {kernel:.1f} ms, idle "
                      f"share {1.0 - busy / wall:.4f}", flush=True)
        frames, samples = timed_frames(scene, cfg, FRAMES)
        for rays, ms in frames:
            print(f"[frame] {label}: {rays} rays, {ms:.2f} ms, "
                  f"{rays / ms / 1e3:.1f} mrays/s", flush=True)
        if samples:
            watts = [w for w, _ in samples]
            mhz = [m for _, m in samples]
            print(f"[power] {label}: {len(samples)} samples, power draw "
                  f"median {statistics.median(watts):.1f} W max "
                  f"{max(watts):.1f} W, SM clock median "
                  f"{statistics.median(mhz):.0f} MHz", flush=True)


if __name__ == "__main__":
    main()
