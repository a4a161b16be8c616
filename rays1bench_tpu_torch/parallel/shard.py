"""Sharded rendering over a device mesh (rays1bench_tpu/parallel/shard.py).

The JAX package splits primary rays over a mesh with shard_map: the scene
and camera are replicated, each device traces its slice, the ray counter is
psum-reduced and the image is a global array. Here each rank of the mesh
(parallel/mesh.py) is one process, and each render is two parts:

- a pure local function of (scene, camera, cfg, mesh shape, coordinate)
  that traces one rank's slice and runs no collective (`plain_local`,
  `kernel_local`), so that one process can run every coordinate in turn:
  NCCL takes one rank a card and gloo gathers no CUDA tensor, so this is
  how a split is held against the single-device frame on one card;
- the collectives: an all_gather of the ranks' equal-size padded slices,
  after which every rank holds the whole image (`assemble_rays`,
  `assemble_pixels`), as every host holds JAX's global array, and an
  all_reduce of the ray counts.

Slices (ray_slice, band): a rank at (tile i, sample j) of an (n_tiles,
n_samples) mesh traces the pixels [i * ppd, (i + 1) * ppd), ppd =
ceil(H * W / n_tiles), and of each pixel the samples [j * spp / n_samples,
(j + 1) * spp / n_samples), in ray-id order; ids past the frame are
padding, never traced or counted. The respawn engine's rank traces the
image rows [i * rpd, (i + 1) * rpd) instead, rpd = ceil(H / n_tiles)
rounded up to the respawn kernel's block height (8 rows), so its warps are
the single-device frame's warps. The stateless RNG keys on global ray ids,
so per-ray results, and the one-shot and wavefront images, are the
single-device port's bit for bit on any mesh; the respawn image is on a
mesh of tiles alone, and on a 2-D mesh differs only in the order of the
sample sums (each rank sums its span, then the spans are added in order).

Dropped TPU arguments: `tile_rays`, `unroll`, `sync_every` and `interpret`
(Mosaic and VPU knobs, and Pallas' CPU mode: the port's CPU path is the
plain version), and the pixel-tile slot permutation, as in
kernels/pipeline.py.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import megakernel
from rays1bench_tpu_torch.kernels.pipeline import (image_of_rays,
                                                   prepare_trimmed)
from rays1bench_tpu_torch.parallel.mesh import layout
from rays1bench_tpu_torch.render.camera import Camera
from rays1bench_tpu_torch.render.pipeline import primary_rays, trace_rays
from rays1bench_tpu_torch.scene.soa_spheres import SphereSOA
from rays1bench_tpu_torch.scene.spheres import prepare


class Slice(NamedTuple):
    """One rank's part of a sharded render."""
    rad: torch.Tensor      # float32 (3, per): per-ray radiance, or per-pixel
                           # sample sums (respawn), padded to the mesh's size
    cnt: Optional[torch.Tensor]  # int32: rays traced per ray of the slice,
                           # or per pixel of the band (respawn; unpadded);
                           # None for the plain renderer
    rays: torch.Tensor     # int64 0-dim: rays traced
    iters: Optional[torch.Tensor] = None  # int64 0-dim: warp trips (telemetry)


def ray_slice(cfg: RenderConfig, n_tiles: int, n_samp: int, i: int, j: int,
              device) -> torch.Tensor:
    """The ray ids (int32, pixel-major, samples innermost) of the rank at
    (i, j): pixels [i * ppd, (i + 1) * ppd) x samples [j * spp_loc,
    (j + 1) * spp_loc); ids >= cfg.num_primary_rays are padding."""
    if cfg.spp % n_samp:
        raise ValueError(f"{n_samp} sample shards do not divide spp "
                         f"{cfg.spp}")
    spp_loc = cfg.spp // n_samp
    ppd = -(-cfg.num_pixels // n_tiles)
    pix = i * ppd + torch.arange(ppd, dtype=torch.int32, device=device)
    s = j * spp_loc + torch.arange(spp_loc, dtype=torch.int32, device=device)
    return (pix[:, None] * cfg.spp + s[None, :]).reshape(-1)


def band(cfg: RenderConfig, n_tiles: int, i: int):
    """(y_lo, y_hi, rows per rank): the image rows of tile i in the respawn
    engine's split, whole kernel blocks of megakernel.BLOCK_ROWS rows."""
    b = megakernel.BLOCK_ROWS
    rows = -(-cfg.height // n_tiles)
    rpd = -(-rows // b) * b
    y_lo = min(i * rpd, cfg.height)
    return y_lo, min(y_lo + rpd, cfg.height), rpd


def _packed(spheres_soa: SphereSOA, cull: str, n_real):
    if cull == "sort_trim":
        return megakernel.pack_spheres(prepare_trimmed(spheres_soa, n_real))
    if cull == "none":
        return megakernel.pack_spheres(prepare(spheres_soa))
    raise ValueError(f"cull is 'sort_trim' or 'none', not {cull!r}")


def kernel_local(spheres_soa: SphereSOA, camera: Camera, cfg: RenderConfig,
                 shape, coord, cull: str = "sort_trim", wavefront=None,
                 n_real=None, respawn: bool = False,
                 telemetry: bool = False) -> Slice:
    """The kernel engines' part of rank `coord` = (tile, sample) of a mesh
    of `shape` = (n_tiles, n_samples): the one-shot kernel
    (megakernel.trace_oneshot) on the rank's ray slice, or with wavefront
    the wavefront engine on it (compaction local to the rank), or with
    respawn the respawn kernel on its band of rows and span of samples. With
    telemetry the kernel's trips too (debug_iters; not with wavefront: the
    phase kernel keeps no counter). cull: "sort_trim" (Morton sort and, with
    n_real, the power-of-two trim) or "none" (the rows as given)."""
    if respawn and wavefront is not None:
        raise ValueError("respawn and wavefront are alternative scheduling "
                         "strategies")
    if telemetry and wavefront is not None:
        raise ValueError("telemetry needs the kernels' trip counter, which "
                         "the phase kernel (wavefront) does not keep")
    (n_tiles, n_samp), (i, j) = shape, coord
    if cfg.spp % n_samp:
        raise ValueError(f"{n_samp} sample shards do not divide spp "
                         f"{cfg.spp}")
    packed = _packed(spheres_soa, cull, n_real)
    spp_loc = cfg.spp // n_samp
    if respawn:
        y_lo, y_hi, rpd = band(cfg, n_tiles, i)
        out = megakernel.trace_respawn(
            packed, megakernel.pack_camera(camera), cfg,
            (j * spp_loc, (j + 1) * spp_loc), (y_lo, y_hi),
            debug_iters=telemetry)
        rad = torch.zeros((3, rpd * cfg.width), dtype=torch.float32,
                          device=packed.device)
        rad[:, :(y_hi - y_lo) * cfg.width] = torch.stack(out[0])
        return Slice(rad, *out[1:])
    ray_id = ray_slice(cfg, n_tiles, n_samp, i, j, packed.device)
    pixel = ray_id // cfg.spp
    rays = [r.contiguous() for r in primary_rays(
        camera, cfg, (pixel % cfg.width).to(torch.float32),
        (pixel // cfg.width).to(torch.float32), ray_id)]
    if wavefront is not None:
        rad, cnt, total = megakernel.trace_wavefront(packed, *rays, ray_id,
                                                     cfg, wavefront)
        return Slice(torch.stack(rad), cnt, total)
    out = megakernel.trace_oneshot(packed, *rays, ray_id, cfg,
                                   debug_iters=telemetry)
    return Slice(torch.stack(out[0]), *out[1:])


def assemble_rays(parts: torch.Tensor, cfg: RenderConfig, shape):
    """The image from every rank's per-ray radiance, parts float32 (ranks,
    3, per) in mesh order: the rays back in ray-id order and the mean over
    spp as render_image_megakernel takes it (kernels.pipeline.
    image_of_rays), so the image is the single-device one bit for bit."""
    n_tiles, n_samp = shape
    spp_loc = cfg.spp // n_samp
    a = parts.reshape(n_tiles, n_samp, 3, -1, spp_loc).permute(2, 0, 3, 1, 4)
    a = a.reshape(3, -1)[:, :cfg.num_primary_rays]
    return image_of_rays(*a, cfg)


def assemble_pixels(parts: torch.Tensor, cfg: RenderConfig, shape):
    """The respawn engine's image from every rank's per-pixel sample sums,
    parts float32 (ranks, 3, per) in mesh order: each pixel's spans added
    in sample order, the bands stacked, then the sums times 1/spp as
    render_image_megakernel takes them."""
    n_tiles, n_samp = shape
    a = parts.reshape(n_tiles, n_samp, 3, -1)
    acc = a[:, 0]
    for j in range(1, n_samp):
        acc = acc + a[:, j]
    rr, rg, rb = acc.permute(1, 0, 2).reshape(3, -1)[:, :cfg.num_pixels]
    rad = torch.stack([rr, rg, rb], dim=-1).reshape(cfg.height, cfg.width, 3)
    return rad * (1.0 / cfg.spp)


def _mesh_order(mesh) -> list:
    return mesh.mesh.flatten().tolist()


def _mesh_group(mesh):
    """The process group a mesh's collectives run on: a 1-D mesh's own
    group (the whole group, or a subgroup from mesh.make_submesh); the
    default group for a 2-D mesh, which spans it (mesh.make_mesh2d)."""
    return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD


def all_gather(local: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's `local` (equal shapes), stacked in mesh order."""
    local = local.contiguous()
    group = _mesh_group(mesh)
    out = [torch.empty_like(local)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, local, group=group)
    return torch.stack([out[dist.get_group_rank(group, r)]
                        for r in _mesh_order(mesh)])


class _Gather(torch.autograd.Function):
    """all_gather of this rank's slice. The loss is computed from the
    gathered stream on every rank alike, so a rank's cotangent of it is
    already the whole one: the backward keeps this rank's slice of it and
    runs no collective."""

    @staticmethod
    def forward(ctx, local, mesh, index):
        ctx.index = index
        return all_gather(local, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.index], None, None


class _Replicated(torch.autograd.Function):
    """Identity on tensors every rank of the mesh holds alike (shard_map's
    P() inputs); the backward sums their cotangents over the mesh's group
    in one all_reduce, as shard_map's transpose psums a replicated
    input's."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.clone() for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        return (None,) + tuple(
            flat.split([g.numel() for g in grads])[k].view_as(g)
            for k, g in enumerate(grads))


def replicated(spheres_soa: SphereSOA, camera: Camera, mesh):
    """The scene and camera through _Replicated over `mesh`'s group when
    autograd records a float tensor of them (else as they are)."""
    objs = (spheres_soa, camera)
    fields = [(k, f.name) for k, o in enumerate(objs)
              for f in dataclasses.fields(o)
              if getattr(o, f.name).is_floating_point()]
    tensors = [getattr(objs[k], name) for k, name in fields]
    if not (torch.is_grad_enabled() and any(t.requires_grad
                                            for t in tensors)):
        return spheres_soa, camera
    new = [{}, {}]
    for (k, name), t in zip(fields, _Replicated.apply(
            _mesh_group(mesh), *tensors)):
        new[k][name] = t
    return tuple(dataclasses.replace(o, **kw) for o, kw in zip(objs, new))


def plain_local(spheres_soa: SphereSOA, camera: Camera, cfg: RenderConfig,
                n_dev: int, d: int) -> Slice:
    """render_image_sharded's part of rank d of n_dev: the plain renderer
    (render.pipeline.trace_rays, with the index kernel as its sweep under
    cfg.pallas_intersect) on the rank's ray slice, differentiable as
    render_image is."""
    ray_id = ray_slice(cfg, n_dev, 1, d, 0, spheres_soa.center_x.device)
    rad, count = trace_rays(prepare(spheres_soa), camera, ray_id, cfg)
    return Slice(rad.t(), None, count)


def render_image_sharded(spheres_soa: SphereSOA, camera: Camera,
                         cfg: RenderConfig, mesh, axis_name: str = "rays"):
    """Render with primary rays sharded over `mesh`'s `axis_name` axis.

    Returns (image float32[H, W, 3] on every rank, num_rays int64 0-dim
    all-reduced): the image equals render_image()'s bit for bit whatever
    the number of ranks. Differentiable as render_image is: the gathered
    image's cotangent goes back to each rank's slice, and the scene's and
    camera's cotangents are summed over the group in one all_reduce (so a
    loss must be computed from the image on every rank alike)."""
    n_dev, _, d, _ = layout(mesh, axis_name)
    spheres_soa, camera = replicated(spheres_soa, camera, mesh)
    part = plain_local(spheres_soa, camera, cfg, n_dev, d)
    count = part.rays.clone()
    dist.all_reduce(count, group=_mesh_group(mesh))
    parts = _Gather.apply(part.rad, mesh, _mesh_order(mesh).index(
        dist.get_rank()))
    return assemble_rays(parts, cfg, (n_dev, 1)), count


def render_image_pallas_sharded(spheres_soa: SphereSOA, camera: Camera,
                                cfg: RenderConfig, mesh,
                                axis_name: str = "rays",
                                cull: str = "sort_trim", wavefront=None,
                                n_real=None, sample_axis=None,
                                respawn: bool = False,
                                telemetry: bool = False):
    """The production multi-device path: the kernel engines with rays split
    over the mesh (kernel_local), the slices all-gathered and the counts
    all-reduced. Equal to render_image_megakernel's image and count, bit
    for bit, except that respawn on a 2-D mesh adds each pixel's sample
    spans in another order (module docstring).

    Engines, as render_image_megakernel: the one-shot kernel by default,
    wavefront= a schedule of bounces per phase (compaction local to each
    rank), respawn=True the respawn kernel on pixel bands. sample_axis:
    the second axis of a 2-D mesh, splitting each pixel's samples (needs
    mesh.size(1) | spp). cull, n_real: kernel_local.

    telemetry: additionally return a third element, {"device_rays":
    rays traced by each rank, "device_iters": the warps' loop trips of
    each rank's kernel (its serial work, the load-imbalance signal a ray
    count cannot show)}, int64 tensors in the mesh's shape. Not with
    wavefront. The split of rays over ranks differs from the JAX
    package's (slot order), so per-rank values differ from its; their sum
    does not.

    Returns (image float32[H, W, 3] on every rank, num_rays int64 0-dim)
    [+ telemetry]."""
    n_tiles, n_samp, i, j = layout(mesh, axis_name, sample_axis)
    part = kernel_local(spheres_soa, camera, cfg, (n_tiles, n_samp), (i, j),
                        cull, wavefront, n_real, respawn, telemetry)
    count = part.rays.clone()
    dist.all_reduce(count, group=_mesh_group(mesh))
    parts = all_gather(part.rad, mesh)
    assemble = assemble_pixels if respawn else assemble_rays
    image = assemble(parts, cfg, (n_tiles, n_samp))
    if not telemetry:
        return image, count
    per_rank = all_gather(torch.stack([part.rays, part.iters]), mesh)
    shape = tuple(mesh.mesh.shape)
    return image, count, {"device_rays": per_rank[:, 0].reshape(shape),
                          "device_iters": per_rank[:, 1].reshape(shape)}
