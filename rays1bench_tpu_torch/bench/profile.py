"""Where a frame's time goes, on one CUDA GPU.

    python -m rays1bench_tpu_torch.bench.profile

Every frame is 1280x720 @ 50 bounces through render_image_megakernel, at
250 spp (the giant scene at 16 spp, since one of its frames at 250 spp takes
half a minute). For the large scene, the headline, it first prints the
table of the spans and counters that utils/profiling records over one
frame under a host-only torch.profiler session (a warm one traced first):
per span its host ms, stream ms and self time (host ms less its
children's), then the frame's rays and, for the respawn engine, its warp
trips and lane occupancy (rays / (32 x trips)); once for the respawn
engine at 250 spp and once for the one-shot engine at the CLI's 10 spp. Then for the large, medium, small
and giant scenes, three frames each timed with CUDA events (rays, ms and
mrays/s), while nvidia-smi samples the power draw and the SM clock every
100 ms (median and max over the samples). The first line names the card
and its power limit.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels.megakernel import WARP_LANES
from rays1bench_tpu_torch.kernels.pipeline import render_image_megakernel
from rays1bench_tpu_torch.scene import builders
from rays1bench_tpu_torch.utils import profiling

SCENES = ("large", "medium", "small", "giant")
FRAMES = 3


def smi(*query: str) -> list:
    out = subprocess.run(["nvidia-smi", "--query-gpu=" + ",".join(query),
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def span_lines(scene, cfg, respawn, label) -> list:
    """The recorder's table of one frame: a line per span, then one of the
    frame's counters."""
    camera = scene.camera.build("cuda")
    for _ in range(2):  # a warm frame, then the one read
        with profiling.session():
            render_image_megakernel(scene.spheres, camera, cfg,
                                    n_real=scene.n_real, respawn=respawn)
        torch.cuda.synchronize()
    out = []
    for r in profiling.table():
        stream = "-" if r["stream_ms"] is None else f"{r['stream_ms']:.3f}"
        out.append(f"[spans] {label}: {r['name']} (in {r['parent']}) host "
                   f"{r['host_ms']:.3f} ms, stream {stream} ms, self "
                   f"{r['self_ms']:.3f} ms")
    rays, trips = profiling.total("rays"), profiling.total("warp_trips")
    occ = (f", warp trips {trips}, lane occupancy "
           f"{100.0 * rays / (WARP_LANES * trips):.3f}%") if trips else ""
    out.append(f"[spans] {label}: {rays} rays{occ}")
    return out


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
            for line in span_lines(scene, cfg, True, f"{label} respawn"):
                print(line, flush=True)
            cli = RenderConfig(width=1280, height=720, spp=10,
                               max_bounces=50)
            for line in span_lines(scene, cli, False,
                                   "large 1280x720 @ 10 spp @ 50 b one-shot"):
                print(line, flush=True)
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
