"""Plain image pipeline: ray generation, chunked wavefront, assembly
(rays1bench_tpu/render/pipeline.py; reference:
src/latest/rayweek1.cpp:722-782). With its defaults this is the port's CPU
oracle: exact float albedos, the plain closest-hit sweep, no kernel. With
cfg.pallas_intersect each bounce's winning row comes from the closest-hit
index kernel (kernels/intersect_index.py; its plain version on the CPU) and
the hit record is rebuilt from it: the engine="pipeline" gradient. With
cfg.soft_silhouette both sweeps are followed by the near-miss promotion in
plain torch (render/intersect._near_miss_index), as the JAX pipeline runs it
in XLA outside its index kernel; the topology replay does not promote.

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
from rays1bench_tpu_torch.scene.spheres import PreparedSpheres, prepare


def primary_rays(camera: Camera, cfg: RenderConfig, x, y, ray_id):
    """Film jitter uv = (rand + xy) / (W, H) (rayweek1.cpp:757-759), then
    the thin-lens ray for each id. x, y: float32 pixel coordinates."""
    ju, jv = rng_mod.pixel_jitter(cfg.seed, ray_id)
    s = (x + ju) * (1.0 / cfg.width)
    t = (y + jv) * (1.0 / cfg.height)
    return camera.generate_rays(s, t, cfg.seed, ray_id)


def primary_rays_from_ids(camera: Camera, cfg: RenderConfig, ray_id):
    """primary_rays of the given ids (int32[N], any order, padding ids >=
    cfg.num_primary_rays included) at their pixels' coordinates, x = pixel
    % W and y = pixel // W of pixel = ray_id // spp: the plain version of
    the raygen kernel (kernels/megakernel.generate_rays)."""
    pixel = ray_id // cfg.spp
    return primary_rays(camera, cfg, (pixel % cfg.width).to(torch.float32),
                        (pixel // cfg.width).to(torch.float32), ray_id)


def render_image(spheres_soa: SphereSOA, camera: Camera, cfg: RenderConfig,
                 topology=None, remat=None):
    """Render a linear-radiance float image.

    topology: optional int32[max_bounces+1, num_primary_rays] winning raw
    SoA row per bounce in ray-id order (-1 where nothing was hit): replay
    mode, no sweep runs and every hit record is rebuilt from the rows
    (integrator.trace). Needs cfg.early_exit=False. Otherwise, with
    cfg.pallas_intersect, the index kernel gives the rows: on a CUDA tensor
    it launches, on a CPU tensor its plain version runs.

    Differentiable with respect to the SphereSOA and camera tensors when
    cfg.early_exit is False. Chunks of cfg.ray_chunk rays bound the sweep's
    (chunk, S) temporaries (trace_rays).

    Returns (image float32[H, W, 3] per-pixel mean radiance, row 0 at the
    bottom; num_rays int64 0-dim tensor, rays traced including bounces)."""
    device = spheres_soa.center_x.device
    ray_id = torch.arange(cfg.num_primary_rays, dtype=torch.int32,
                          device=device)
    rad, num_rays = trace_rays(prepare(spheres_soa), camera, ray_id, cfg,
                               topology, remat)
    image = rad.reshape(cfg.height, cfg.width, cfg.spp, 3).mean(dim=2)
    return image, num_rays


def trace_rays(spheres: PreparedSpheres, camera: Camera, ray_id,
               cfg: RenderConfig, topology=None, remat=None):
    """Generate and trace the primary rays of the given global ids (int32[N]
    in any order), cfg.ray_chunk at a time: the chunk body of render_image
    and the counterpart of the JAX pipeline's _trace_chunk, which the
    sharded and retried renders (parallel/) run on their slices. Ids >=
    cfg.num_primary_rays are padding: never alive, never counted.

    topology: optional int32[max_bounces+1, N] rows of these rays (replay
    mode, see render_image). Under autograd every chunk's graph lives until
    the backward; in index and replay mode `remat` (default: on when there
    is more than one chunk, as in the JAX pipeline) checkpoints each bounce
    so that only its inputs and rows stay saved.

    Returns (radiance float32[N, 3]; num_rays int64 0-dim tensor)."""
    n = ray_id.shape[0]
    if remat is None:
        remat = n > cfg.ray_chunk
    hit_index = None
    if cfg.pallas_intersect and topology is None:
        # Imported here: kernels/ imports this module.
        from rays1bench_tpu_torch.kernels.intersect_index import \
            closest_hit_index
        hit_index = lambda *r: closest_hit_index(spheres, *r, cfg.t_min)
    rad = []
    num_rays = torch.zeros((), dtype=torch.int64, device=ray_id.device)
    for lo in range(0, n, cfg.ray_chunk):
        ids = ray_id[lo:lo + cfg.ray_chunk]
        rays = primary_rays_from_ids(camera, cfg, ids)
        topo = None
        if topology is not None:
            idx = topology[:, lo:lo + ids.shape[0]]
            topo = (idx, idx >= 0)
        (rr, rg, rb), count = trace(spheres, *rays, cfg.seed, ids,
                                    max_bounces=cfg.max_bounces,
                                    t_min=cfg.t_min, t_max=cfg.t_max,
                                    early_exit=cfg.early_exit, topology=topo,
                                    hit_index=hit_index, remat=remat,
                                    soft_eps=cfg.soft_silhouette,
                                    active=ids < cfg.num_primary_rays)
        rad.append(torch.stack([rr, rg, rb], dim=-1))
        num_rays += count.sum(dtype=torch.int64)
    return torch.cat(rad), num_rays


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
