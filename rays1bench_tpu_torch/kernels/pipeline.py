"""Kernel-backed render pipeline (rays1bench_tpu/kernels/pipeline.py, the
respawn engine).

Same contract as render.pipeline.render_image (same RNG lattice per ray id),
with the whole path in the respawn kernel and the albedo quantized to 8 bits
in the packed sphere table (megakernel.pack_spheres).

Left out, with the reason: the pixel-tile slot permutation and its
unpermute (the kernel writes straight into image order); tile_rays, unroll
and sync_every (Mosaic and VPU tuning knobs with no meaning for a thread per
pixel); the cull option, since "sort_trim" was the only trim the JAX
pipeline kept besides "none". The power-of-two row trim stays: it is
harmless and keeps the row count, and so the first-wins tie order, equal to
the JAX side's.
"""

from __future__ import annotations

from typing import Optional

import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import culling
from rays1bench_tpu_torch.kernels.megakernel import (pack_camera, pack_spheres,
                                                     trace_respawn)
from rays1bench_tpu_torch.render.camera import Camera
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
