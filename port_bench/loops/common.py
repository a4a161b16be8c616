"""What the window loops share: the run's settings, the inputs made from
the seed, device synchronisation, and the check of a rendered frame against
the plain reference."""

from __future__ import annotations

import dataclasses
import gc
import numpy as np
import torch

from port_bench import harness
from port_bench import trace as tr
from port_bench.reference import render as ref
from port_bench.reference import scenes


@dataclasses.dataclass
class Run:
    """One run of one cell. small: settings that replace the
    configuration's and the mix's (the CPU tests' tiny sizes); None on the
    card."""
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    small: dict = None


def settings(run: Run) -> dict:
    """The render settings: the configuration's, then the mix's, then the
    run's small ones."""
    out = dict(run.cell["config"]["render"])
    out.update(run.cell["traffic"].get("render", {}))
    out.update((run.small or {}).get("render", {}))
    return out


def traffic(run: Run, key: str):
    return (run.small or {}).get(key, run.cell["traffic"][key])


def inputs(run: Run):
    """(columns, n_real, camera spec, render seed, numpy Generator) from
    the seed: the scene of the configuration, and a render seed drawn from
    --seed so every seed traces the same frame size on another lattice."""
    cfg = run.cell["config"]
    cols, n_real = scenes.SCENES[cfg["scene"]](cfg["pad"])
    rng = np.random.default_rng(run.seed)
    seed = int(rng.integers(1, 2 ** 31 - 1))
    return cols, n_real, dict(scenes.CAMERA), seed, rng


def program_scene(cols, cam_spec, r, device):
    """The program's SphereSOA and Camera for these inputs."""
    from rays1bench_tpu_torch.render.camera import CameraSpec
    from rays1bench_tpu_torch.scene.soa_spheres import SphereSOA
    soa = SphereSOA(**{k: torch.from_numpy(v.copy()).to(device)
                       for k, v in cols.items()})
    spec = CameraSpec(aspect=r["width"] / r["height"], **cam_spec)
    return soa, spec.build(device)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Fence:
    """A CUDA event on the current stream, or nothing on the CPU."""

    def __init__(self, device):
        self.ev = None
        if device.type == "cuda":
            self.ev = torch.cuda.Event()
            self.ev.record()

    def wait(self):
        if self.ev is not None:
            self.ev.synchronize()


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def closed_loop(frame, in_flight, device, window, done):
    """Issue frame() -> (image, count) back to back, at most in_flight
    queued, until done(frames issued) holds; the window ends when the last
    frame does. Returns (the last image, [every frame's count])."""
    counts, pending = [], []
    while True:
        image, count = frame()
        counts.append(count)
        pending.append(Fence(device))
        if len(pending) >= in_flight:
            pending.pop(0).wait()
        window.tick()
        if done(len(counts)):
            return image, counts


def window(run: Run):
    """The run's measured window (trace.Window), traced over the mix's
    trace_seconds when the run is traced."""
    return tr.Window(run.trace, lambda: sync(run.device),
                     traffic(run, "trace_seconds"))


def check_pixels(width, height, tile, rng) -> np.ndarray:
    """One pixel id drawn from the seed in each tile[0] x tile[1] tile of
    the image (the tiles divide it)."""
    tw, th = tile
    if width % tw or height % th:
        raise ValueError(f"tile {tile} does not divide {width}x{height}")
    gx, gy = width // tw, height // th
    ox = rng.integers(0, tw, size=(gy, gx))
    oy = rng.integers(0, th, size=(gy, gx))
    x = np.arange(gx)[None, :] * tw + ox
    y = np.arange(gy)[:, None] * th + oy
    return (y * width + x).reshape(-1)


def count_paths(width, height, spp, per_pixel, rng) -> np.ndarray:
    """Primary ray ids (pixel * spp + sample) drawn from the seed: every
    pixel's samples split into `per_pixel` runs of equal length, one sample
    drawn from each, so that their counts estimate the frame's."""
    if spp % per_pixel:
        raise ValueError(f"{per_pixel} paths a pixel do not divide {spp} spp")
    run = spp // per_pixel
    sample = rng.integers(0, run, size=(width * height, per_pixel)) \
        + np.arange(per_pixel) * run
    return (np.arange(width * height)[:, None] * spp + sample).reshape(-1)


def check_draws(run: Run, r: dict, rng) -> tuple:
    """(pixels, paths): what the check of a rendered frame traces, drawn
    from the seed in this order by the program's run and the control's."""
    pixels = check_pixels(r["width"], r["height"],
                          traffic(run, "check_tile"), rng)
    paths = count_paths(r["width"], r["height"], r["spp"],
                        traffic(run, "count_paths_per_pixel"), rng)
    return pixels, paths


def frame_check(image, frame_rays, cols, cam_spec, draws, r, seed, respawn,
                device):
    """The numbers that judge one frame against the reference: pixel_gap,
    the widest gap of a channel of a sampled pixel (every sample traced);
    rays_gap, the frame's ray count against the count that the sampled
    paths estimate (their mean count times the frame's paths), as a share
    of the estimate."""
    pixels, paths = draws
    img, _ = ref.render_pixels(cols, cam_spec, pixels, r["width"],
                               r["height"], r["spp"], seed, r["max_bounces"],
                               device, respawn=respawn)
    est = estimate_rays(cols, cam_spec, paths, r, seed, device)
    got = image.reshape(-1, 3)[torch.as_tensor(pixels)].float()
    return {"pixel_gap": float((got - img.cpu()).abs().max()),
            "rays_gap": abs(frame_rays - est) / est}


def estimate_rays(cols, cam_spec, paths, r, seed, device,
                  dtype=torch.float32) -> float:
    """The frame's ray count as the sampled paths estimate it."""
    traced = ref.count_rays(cols, cam_spec, paths, r["width"], r["height"],
                            r["spp"], seed, r["max_bounces"], device, dtype)
    return traced * (r["width"] * r["height"] * r["spp"] / len(paths))


def finish(values, limits, **result):
    correct, checks = harness.judge(values, limits)
    return dict(result, correct=correct, checks=checks)
