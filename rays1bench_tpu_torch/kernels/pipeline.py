"""Kernel-backed render pipeline (rays1bench_tpu/kernels/pipeline.py): the
respawn engine, and the topology-emitting one-shot forward of the gradient
path.

Same contract as render.pipeline.render_image (same RNG lattice per ray id),
with the whole path in a kernel and the albedo quantized to 8 bits in the
packed sphere table (megakernel.pack_spheres).

Left out, with the reason: the pixel-tile slot permutation and its
unpermute (the kernel writes straight into image order); tile_rays, unroll
and sync_every (Mosaic and VPU tuning knobs with no meaning for a thread per
pixel); the cull option, since "sort_trim" was the only trim the JAX
pipeline kept besides "none" (render_image_topology is the cull="none"
case). render_image_topology feeds the kernel in ray-id order, one thread
per ray: the slot order, slot_layout, _tile_coords, _slot_of_id,
sync_every and unroll of the JAX topology path are TPU workarounds. The power-of-two row trim stays: it is
harmless and keeps the row count, and so the first-wins tie order, equal to
the JAX side's.
"""

from __future__ import annotations

from typing import Optional

import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import culling
from rays1bench_tpu_torch.kernels.megakernel import (pack_camera, pack_spheres,
                                                     trace_respawn,
                                                     trace_topology)
from rays1bench_tpu_torch.render.camera import Camera
from rays1bench_tpu_torch.render.pipeline import primary_rays
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS, SphereSOA
from rays1bench_tpu_torch.scene.spheres import PreparedSpheres, prepare

# Rows are kept in multiples of this (the JAX pipeline's granule at its
# default auto unroll).
_GRANULE = 8


def _keep_count(n_real: int, n_padded: int, granule: int) -> int:
    """Power-of-two row count to keep after sorting (>= granule)."""
    keep = granule
    while keep < n_real:
        keep *= 2
    keep = min(keep, n_padded)
    return max(-(-keep // granule) * granule, granule)


def prepare_trimmed(spheres_soa: SphereSOA,
                    n_real: Optional[int] = None) -> PreparedSpheres:
    """Morton-sort the rows (placeholders last) and, when n_real (the count
    of real spheres, builders.Scene.n_real) is given, drop placeholder rows
    down to the next power of two: small 128 -> 8 rows, large 512 -> 512.
    The JAX package's prepare_trimmed with cull="sort_trim"."""
    valid = spheres_soa.radius != 0.0
    perm = culling.morton_order(spheres_soa.center_x, spheres_soa.center_y,
                                spheres_soa.center_z, valid)
    n = perm.shape[0]
    keep = (_keep_count(n_real, n, _GRANULE) if n_real is not None
            else max(-(-n // _GRANULE) * _GRANULE, _GRANULE))
    idx = perm[:keep]
    return prepare(SphereSOA(**{c: getattr(spheres_soa, c)[idx]
                                for c in COLUMNS}))


def render_image_megakernel(spheres_soa: SphereSOA, camera: Camera,
                            cfg: RenderConfig, n_real: Optional[int] = None):
    """Render a linear-radiance float image through the respawn kernel.

    The counterpart of the JAX package's
    kernels/pipeline.render_image_pallas(respawn=True); the one-shot and
    wavefront engines are not ported yet. Runs the CUDA kernel when the
    scene's tensors are on a CUDA device and its plain version on the CPU.

    Returns (image float32[H, W, 3], mean radiance per pixel, row 0 at the
    bottom; num_rays int64 0-dim tensor)."""
    spheres = prepare_trimmed(spheres_soa, n_real)
    (rr, rg, rb), _, total = trace_respawn(pack_spheres(spheres),
                                           pack_camera(camera), cfg)
    rad = torch.stack([rr, rg, rb], dim=-1).reshape(cfg.height, cfg.width, 3)
    return rad * (1.0 / cfg.spp), total


def ray_coords(cfg: RenderConfig, device):
    """(ray_id int32[N], x, y float32[N]) of every primary ray in ray-id
    order, ray_id = (y * W + x) * spp + s."""
    ray_id = torch.arange(cfg.num_primary_rays, dtype=torch.int32,
                          device=device)
    pixel = ray_id // cfg.spp
    return (ray_id, (pixel % cfg.width).to(torch.float32),
            (pixel // cfg.width).to(torch.float32))


def image_of_rays(rr, rg, rb, cfg: RenderConfig):
    """Per-ray radiance in ray-id order -> float32[H, W, 3] mean over spp."""
    rad = torch.stack([rr, rg, rb], dim=-1)
    return rad.reshape(cfg.height, cfg.width, cfg.spp, 3).mean(dim=2)


def _trace_packed(prep: PreparedSpheres, *rays_and_id, cfg: RenderConfig):
    return trace_topology(pack_spheres(prep), *rays_and_id, cfg)


def render_image_topology(spheres_soa: SphereSOA, camera: Camera,
                          cfg: RenderConfig, trace=_trace_packed):
    """The one-shot kernel forward that also returns the hit topology
    (render_image_pallas_topology). No row trim or sort (cull="none"): the
    topology's indices are raw SoA rows, so gradients land on the right
    rows; pad scenes tightly (pad_multiple=8). Runs the CUDA kernel when the
    scene's tensors are on a CUDA device and its plain version on the CPU.

    trace(prep, ox, oy, oz, dx, dy, dz, ray_id, cfg=cfg) -> ((rr, rg, rb),
    counts, num_rays, topology) is the kernel call; grad.mega passes its
    autograd Function in its place.

    Returns (image float32[H, W, 3], num_rays int64 0-dim tensor, topology
    int32[max_bounces+1, num_primary_rays] in ray-id order)."""
    ray_id, x, y = ray_coords(cfg, spheres_soa.center_x.device)
    rays = [r.contiguous() for r in primary_rays(camera, cfg, x, y, ray_id)]
    (rr, rg, rb), _, total, topo = trace(prepare(spheres_soa), *rays, ray_id,
                                         cfg=cfg)
    return image_of_rays(rr, rg, rb, cfg), total, topo
