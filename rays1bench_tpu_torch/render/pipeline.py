"""Plain image pipeline: ray generation, chunked wavefront, assembly
(rays1bench_tpu/render/pipeline.py; reference:
src/latest/rayweek1.cpp:722-782). This is the port's CPU oracle: exact float
albedos, the plain closest-hit sweep, no kernel.

Every primary ray has the global id ray_id = (y * W + x) * spp + s, from
which pixel, film jitter, lens sample and every bounce's draws follow
statelessly (core/rng.py), so chunking cannot change the image. Row
convention: y = 0 is the bottom image row (v = y / H).
"""

from __future__ import annotations

import torch

from rays1bench_tpu_torch.core import rng as rng_mod
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.core.vecmath import sqrt
from rays1bench_tpu_torch.render.camera import Camera
from rays1bench_tpu_torch.render.integrator import trace
from rays1bench_tpu_torch.scene.soa_spheres import SphereSOA
from rays1bench_tpu_torch.scene.spheres import prepare


def primary_rays(camera: Camera, cfg: RenderConfig, x, y, ray_id):
    """Film jitter uv = (rand + xy) / (W, H) (rayweek1.cpp:757-759), then
    the thin-lens ray for each id. x, y: float32 pixel coordinates."""
    ju, jv = rng_mod.pixel_jitter(cfg.seed, ray_id)
    s = (x + ju) * (1.0 / cfg.width)
    t = (y + jv) * (1.0 / cfg.height)
    return camera.generate_rays(s, t, cfg.seed, ray_id)


def render_image(spheres_soa: SphereSOA, camera: Camera, cfg: RenderConfig,
                 topology=None):
    """Render a linear-radiance float image.

    topology: optional int32[max_bounces+1, num_primary_rays] winning raw
    SoA row per bounce in ray-id order (-1 where nothing was hit): replay
    mode, no sweep runs and every hit record is rebuilt from the rows
    (integrator.trace). Needs cfg.early_exit=False. Differentiable with
    respect to the SphereSOA and camera tensors when cfg.early_exit is
    False. Chunks of cfg.ray_chunk rays bound the plain sweep's (chunk, S)
    temporaries; under autograd every chunk's graph lives until the
    backward, so they bound nothing there.

    Returns (image float32[H, W, 3] per-pixel mean radiance, row 0 at the
    bottom; num_rays int64 0-dim tensor, rays traced including bounces)."""
    spheres = prepare(spheres_soa)
    device = spheres_soa.center_x.device
    n = cfg.num_primary_rays
    rad = []
    num_rays = torch.zeros((), dtype=torch.int64, device=device)
    for lo in range(0, n, cfg.ray_chunk):
        ray_id = torch.arange(lo, min(lo + cfg.ray_chunk, n),
                              dtype=torch.int32, device=device)
        pixel = ray_id // cfg.spp
        x = (pixel % cfg.width).to(torch.float32)
        y = (pixel // cfg.width).to(torch.float32)
        rays = primary_rays(camera, cfg, x, y, ray_id)
        topo = None
        if topology is not None:
            idx = topology[:, lo:lo + ray_id.shape[0]]
            topo = (idx, idx >= 0)
        (rr, rg, rb), count = trace(spheres, *rays, cfg.seed, ray_id,
                                    max_bounces=cfg.max_bounces,
                                    t_min=cfg.t_min, t_max=cfg.t_max,
                                    early_exit=cfg.early_exit, topology=topo)
        rad.append(torch.stack([rr, rg, rb], dim=-1))
        num_rays += count.sum(dtype=torch.int64)
    image = torch.cat(rad).reshape(cfg.height, cfg.width, cfg.spp, 3).mean(dim=2)
    return image, num_rays


def to_srgb_u8(image: torch.Tensor) -> torch.Tensor:
    """Gamma (sqrt) + 255.99 quantization to uint8 (rayweek1.cpp:765-775)."""
    g = sqrt(torch.clamp(image, 0.0, 1.0))
    return (g * 255.99).to(torch.uint8)


def render_scene(scene, cfg: RenderConfig):
    """Build the camera on the scene's device, render, quantize.
    Returns (u8 image[H, W, 3] with row 0 = bottom, num_rays: int)."""
    camera = scene.camera.build(scene.spheres.center_x.device)
    image, num_rays = render_image(scene.spheres, camera, cfg)
    return to_srgb_u8(image), int(num_rays)
