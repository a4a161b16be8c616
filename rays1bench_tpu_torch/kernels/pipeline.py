"""Kernel-backed render pipeline (rays1bench_tpu/kernels/pipeline.py): the
respawn, one-shot and wavefront render engines, and the topology-emitting
one-shot forward of the gradient path.

Same contract as render.pipeline.render_image (same RNG lattice per ray id),
with the whole path in a kernel and the albedo quantized to 8 bits in the
packed sphere table (megakernel.pack_spheres).

Left out, with the reason: the pixel-tile slot permutation and its
unpermute (the kernels write straight into image or ray-id order);
tile_rays, unroll and sync_every (Mosaic and VPU tuning knobs with no
meaning for a thread per pixel or ray); the cull option, since "sort_trim"
was the only trim the JAX pipeline kept besides "none"
(render_image_topology is the cull="none" case). The one-shot, wavefront
and topology paths feed their kernel the primary rays that
megakernel.generate_rays makes from the ray ids, in ray-id order:
the slot order, slot_layout, _tile_coords, _slot_of_id, sync_every and
unroll of the JAX paths are TPU workarounds. The power-of-two row trim
stays: it is harmless and keeps the row count, and so the first-wins tie
order, equal to the JAX side's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import culling
from rays1bench_tpu_torch.kernels.megakernel import (generate_rays,
                                                     pack_camera, pack_spheres,
                                                     respawn_iters_reference,
                                                     trace_oneshot,
                                                     trace_respawn,
                                                     trace_topology,
                                                     trace_wavefront)
from rays1bench_tpu_torch.render.camera import Camera
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS, SphereSOA
from rays1bench_tpu_torch.scene.spheres import PreparedSpheres, prepare
from rays1bench_tpu_torch.utils import profiling

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
                            cfg: RenderConfig, n_real: Optional[int] = None,
                            respawn: bool = True,
                            wavefront: Optional[Tuple[int, ...]] = None):
    """Render a linear-radiance float image through a kernel engine: the
    counterpart of the JAX package's kernels/pipeline.render_image_pallas.

    respawn=True: the respawn kernel, one thread per pixel tracing all its
    samples (megakernel.trace_respawn). respawn=False: the primary rays in
    ray-id order through the one-shot kernel (megakernel.trace_oneshot),
    or, with wavefront = bounces per phase such as (2, 3, 6), through the
    wavefront engine (megakernel.trace_wavefront), whose image and ray count
    equal the one-shot engine's bit for bit. The one-shot engine's ray count
    equals the respawn engine's; its image differs only in the order of the
    sample sum. The default is respawn=True, where the JAX default is the
    one-shot engine: the port's callers kept their engine when the other two
    arrived. respawn and wavefront together raise, as in the JAX package.
    Runs the CUDA kernels when the scene's tensors are on a CUDA device and
    their plain versions on the CPU.

    While utils/profiling records, the frame records the spans "frame" and,
    inside it, "prepare" (the Morton sort, trim and packing), "raygen" (the
    ray ids and megakernel.generate_rays; not with respawn), "kernel" and
    "reduce" (the image), on the stream too where the scene is on a CUDA
    device, and the counters "rays", "raygen_kernel_rays" (not with
    respawn; generate_rays) and, with respawn, "warp_trips"
    (count_warp_trips).

    Returns (image float32[H, W, 3], mean radiance per pixel, row 0 at the
    bottom; num_rays int64 0-dim tensor)."""
    if respawn and wavefront is not None:
        raise ValueError("respawn and wavefront are alternative scheduling "
                         "strategies")
    cuda = spheres_soa.center_x.is_cuda
    with profiling.span("frame", cuda):
        with profiling.span("prepare", cuda):
            packed = pack_spheres(prepare_trimmed(spheres_soa, n_real))
            if respawn:
                cam = pack_camera(camera)
        if respawn:
            with profiling.span("kernel", cuda):
                out = trace_respawn(packed, cam, cfg)
            with profiling.span("reduce", cuda):
                rad = torch.stack(out[0], dim=-1).reshape(cfg.height,
                                                          cfg.width, 3)
                image = rad * (1.0 / cfg.spp)
        else:
            with profiling.span("raygen", cuda):
                ray_id = frame_ray_ids(cfg, packed.device)
                rays = generate_rays(camera, cfg, ray_id)
            with profiling.span("kernel", cuda):
                out = (trace_oneshot(packed, *rays, ray_id, cfg)
                       if wavefront is None else
                       trace_wavefront(packed, *rays, ray_id, cfg,
                                       wavefront))
            with profiling.span("reduce", cuda):
                image = image_of_rays(*out[0], cfg)
        profiling.count("rays", out[2])
        if respawn:
            count_warp_trips(out[1], cfg.width)
    return image, out[2]


def count_warp_trips(cnt: torch.Tensor, width: int) -> None:
    """While utils/profiling records, the counter "warp_trips" of the
    respawn kernel's rows (a frame, or a rank's blocks of rows,
    parallel/shard.band): its warps' loop trips, which its kIters
    instantiation counts on the card and respawn_iters_reference gives
    exactly from the per-pixel counts cnt. The counter keeps cnt and takes
    the reference when it is read, so the traced frame runs the kernel
    without kIters and adds no work to the stream."""
    if profiling.recording():
        profiling.count("warp_trips",
                        lambda: respawn_iters_reference(cnt, width))


def frame_ray_ids(cfg: RenderConfig, device):
    """ray_id int32[N] of every primary ray of the frame in ray-id order,
    ray_id = (y * W + x) * spp + s: what megakernel.generate_rays and
    render.pipeline.primary_rays_from_ids make the rays from."""
    return torch.arange(cfg.num_primary_rays, dtype=torch.int32,
                        device=device)


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

    While utils/profiling records, the render records the spans "prepare"
    (scene/spheres.prepare), "raygen" (the ray ids and
    megakernel.generate_rays, which counts "raygen_kernel_rays"), "kernel"
    (the kernel call, the table's packing included) and "reduce" (the
    image), on the stream too where the scene is on a CUDA device, inside
    the span open around the call (a training step's "forward",
    grad/inverse.make_train_step, which also counts the ray total).

    Returns (image float32[H, W, 3], num_rays int64 0-dim tensor, topology
    int32[max_bounces+1, num_primary_rays] in ray-id order)."""
    cuda = spheres_soa.center_x.is_cuda
    with profiling.span("prepare", cuda):
        prep = prepare(spheres_soa)
    with profiling.span("raygen", cuda):
        ray_id = frame_ray_ids(cfg, spheres_soa.center_x.device)
        rays = generate_rays(camera, cfg, ray_id)
    with profiling.span("kernel", cuda):
        (rr, rg, rb), _, total, topo = trace(prep, *rays, ray_id, cfg=cfg)
    with profiling.span("reduce", cuda):
        image = image_of_rays(rr, rg, rb, cfg)
    return image, total, topo
