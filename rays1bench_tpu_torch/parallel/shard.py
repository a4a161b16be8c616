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
padding, never traced or counted. The respawn engine's rank traces whole
blocks of the respawn kernel's 8 rows instead, interleaved: block-rows i,
i + n_tiles, i + 2 n_tiles, ..., so that its warps are the single-device
frame's warps and each rank holds a cross-section of the frame, sky and
crowded horizon alike, which balances the ranks' work. Ranks hold
ceil(ceil(H / 8) / n_tiles) blocks, or one fewer, and pad to the former.
The stateless RNG keys on global ray ids, so per-ray results, and the
one-shot and wavefront images, are the single-device port's bit for bit
on any mesh; the respawn image is on a mesh of tiles alone, and on a 2-D
mesh differs only in the order of the sample sums (each rank sums its
span, then the spans are added in order).

Dropped TPU arguments: `tile_rays`, `unroll`, `sync_every` and `interpret`
(Mosaic and VPU knobs, and Pallas' CPU mode: the port's CPU path is the
plain version), and the pixel-tile slot permutation, as in
kernels/pipeline.py.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import megakernel
from rays1bench_tpu_torch.kernels.pipeline import (count_warp_trips,
                                                   image_of_rays,
                                                   prepare_trimmed)
from rays1bench_tpu_torch.parallel.mesh import layout
from rays1bench_tpu_torch.render.camera import Camera
from rays1bench_tpu_torch.render.pipeline import trace_rays
from rays1bench_tpu_torch.scene.soa_spheres import SphereSOA
from rays1bench_tpu_torch.scene.spheres import prepare
from rays1bench_tpu_torch.utils import profiling


class Slice(NamedTuple):
    """One rank's part of a sharded render."""
    rad: torch.Tensor      # float32 (3, per): per-ray radiance, or per-pixel
                           # sample sums (respawn), padded to the mesh's size
    cnt: Optional[torch.Tensor]  # int32: rays traced per ray of the slice,
                           # or per pixel of the blocks (respawn; unpadded);
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
    """(rows, rows per rank): tile i's part of the respawn engine's split,
    the rows= of megakernel.trace_respawn that takes every n_tiles-th
    block-row of megakernel.BLOCK_ROWS rows from block-row i, and the rows
    every rank pads its part to (ceil(block-rows / n_tiles) blocks)."""
    b = megakernel.BLOCK_ROWS
    blocks = -(-cfg.height // b)
    return ((min(i * b, cfg.height), cfg.height, n_tiles),
            -(-blocks // n_tiles) * b)


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
    respawn the respawn kernel on its blocks of rows (band) and span of
    samples. With telemetry the kernel's trips too (debug_iters; not with
    wavefront: the phase kernel keeps no counter). cull: "sort_trim"
    (Morton sort and, with n_real, the power-of-two trim) or "none" (the
    rows as given). Records
    render_image_megakernel's spans "prepare", "raygen" and "kernel" and
    counters "rays", "raygen_kernel_rays" (not with respawn) and, with
    respawn, "warp_trips" while utils/profiling records."""
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
    cuda = spheres_soa.center_x.is_cuda
    with profiling.span("prepare", cuda):
        packed = _packed(spheres_soa, cull, n_real)
        if respawn:
            cam = megakernel.pack_camera(camera)
    spp_loc = cfg.spp // n_samp
    if respawn:
        rows, per = band(cfg, n_tiles, i)
        with profiling.span("kernel", cuda):
            out = megakernel.trace_respawn(
                packed, cam, cfg, (j * spp_loc, (j + 1) * spp_loc), rows,
                debug_iters=telemetry)
        rad = torch.zeros((3, per * cfg.width), dtype=torch.float32,
                          device=packed.device)
        rad[:, :out[1].numel()] = torch.stack(out[0])
    else:
        with profiling.span("raygen", cuda):
            ray_id = ray_slice(cfg, n_tiles, n_samp, i, j, packed.device)
            rays = megakernel.generate_rays(camera, cfg, ray_id)
        with profiling.span("kernel", cuda):
            out = (megakernel.trace_wavefront(packed, *rays, ray_id, cfg,
                                              wavefront)
                   if wavefront is not None else
                   megakernel.trace_oneshot(packed, *rays, ray_id, cfg,
                                            debug_iters=telemetry))
        rad = torch.stack(out[0])
    profiling.count("rays", out[2])
    if respawn:
        count_warp_trips(out[1], cfg.width)
    return Slice(rad, *out[1:])


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
    in sample order, the tiles' blocks put back in image order (block-row
    k * n_tiles + i is tile i's k-th, band) and the padding cropped, then
    the sums times 1/spp as render_image_megakernel takes them."""
    n_tiles, n_samp = shape
    a = parts.reshape(n_tiles, n_samp, 3, -1,
                      megakernel.BLOCK_ROWS * cfg.width)
    acc = a[:, 0]
    for j in range(1, n_samp):
        acc = acc + a[:, j]
    rr, rg, rb = acc.permute(1, 2, 0, 3).reshape(3, -1)[:, :cfg.num_pixels]
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
    rank), respawn=True the respawn kernel on interleaved blocks of rows
    (band). sample_axis: the second axis of a 2-D mesh, splitting each
    pixel's samples (needs mesh.size(1) | spp). cull, n_real:
    kernel_local.

    telemetry: additionally return a third element, {"device_rays":
    rays traced by each rank, "device_iters": the warps' loop trips of
    each rank's kernel (its serial work, the load-imbalance signal a ray
    count cannot show)}, int64 tensors in the mesh's shape. Not with
    wavefront. The split of rays over ranks differs from the JAX
    package's (slot order), so per-rank values differ from its; their sum
    does not.

    While utils/profiling records, the frame records the spans "frame"
    and, inside it, "local" (kernel_local's "prepare", "raygen" and
    "kernel"), "all_reduce", "all_gather", "assemble" and, with telemetry,
    "telemetry", on the stream too where the scene is on a CUDA device; the
    counters "rays", "warp_trips" (with respawn) and, with telemetry,
    "ranks": the gathered rows of RANK_ROW, which carry each rank's times
    of an earlier frame to every rank's recorder (rank_timings).

    Returns (image float32[H, W, 3] on every rank, num_rays int64 0-dim)
    [+ telemetry]."""
    n_tiles, n_samp, i, j = layout(mesh, axis_name, sample_axis)
    cuda = spheres_soa.center_x.is_cuda
    with profiling.span("frame", cuda):
        with profiling.span("local", cuda):
            part = kernel_local(spheres_soa, camera, cfg, (n_tiles, n_samp),
                                (i, j), cull, wavefront, n_real, respawn,
                                telemetry)
        with profiling.span("all_reduce", cuda):
            count = part.rays.clone()
            dist.all_reduce(count, group=_mesh_group(mesh))
        with profiling.span("all_gather", cuda):
            parts = all_gather(part.rad, mesh)
        with profiling.span("assemble", cuda):
            assemble = assemble_pixels if respawn else assemble_rays
            image = assemble(parts, cfg, (n_tiles, n_samp))
        if not telemetry:
            return image, count
        with profiling.span("telemetry", cuda):
            per_rank = all_gather(_rank_row(part), mesh)
        if profiling.recording():
            profiling.count("ranks", per_rank)
    shape = tuple(mesh.mesh.shape)
    return image, count, {"device_rays": per_rank[:, 0].reshape(shape),
                          "device_iters": per_rank[:, 1].reshape(shape)}


# A rank's row of the telemetry gather: its rays and warp trips in this
# frame, then, as float64 bits, the id of its oldest frame not sent before
# whose spans have passed on its stream, that frame's "local" ms and ms
# from reaching "all_reduce" to the end of "all_gather" (stream ms on a
# card, host ms on the CPU), and its "frame" span's host ms (the host's
# issue); -1 in each where there is none or utils/profiling is not
# recording. Every rank sends a row of one length whether it records or
# not: the ranks' profiler sessions need not start and stop together.
RANK_ROW = ("rays", "iters", "frame", "local_ms", "collective_ms",
            "issue_ms")
_TIMED = ("frame", "local", "all_reduce", "all_gather")


def _rank_row(part: Slice) -> torch.Tensor:
    row = torch.stack([part.rays, part.iters])
    done = profiling.completed(_TIMED) if profiling.recording() else None
    if done is None:
        ms = torch.full((4,), -1.0, dtype=torch.float64, device=row.device)
    else:
        f, sp = done
        ms = torch.tensor(
            [float(f), profiling.interval_ms(sp["local"], sp["local"]),
             profiling.interval_ms(sp["all_reduce"], sp["all_gather"]),
             sp["frame"].host_ms], dtype=torch.float64)
        if row.is_cuda:
            # Pinned and non-blocking: the copy does not wait for the
            # stream.
            ms = ms.pin_memory().to(row.device, non_blocking=True)
    return torch.cat([row, ms.view(torch.int64)])


def rank_rows(per_rank: torch.Tensor) -> list:
    """The telemetry gather's rows (a "ranks" counter of utils/profiling)
    as one dict of RANK_ROW a rank, in mesh order."""
    t = per_rank.cpu()
    return [dict(zip(RANK_ROW, r[:2].tolist()
                     + r[2:].view(torch.float64).tolist())) for r in t]


def rank_timings(st=None) -> dict:
    """Rank 0's record of the sharded frames, from its "ranks" counters:
    {frame id: {"busiest": the rank with most warp trips in that frame,
    "ranks": {rank: {"local_ms", "collective_ms", "issue_ms"}}}} for the
    frames whose rows arrived (a rank sends a frame's times with a later
    frame's gather). Read after the caller has synchronised."""
    iters, times = {}, {}
    for f, t in profiling.counts("ranks", st):
        rows = rank_rows(t)
        iters[f] = max(range(len(rows)), key=lambda r: rows[r]["iters"])
        for r, row in enumerate(rows):
            if row["frame"] >= 0:
                times.setdefault(int(row["frame"]), {})[r] = {
                    k: row[k] for k in RANK_ROW[3:]}
    return {f: {"busiest": b, "ranks": times[f]}
            for f, b in iters.items() if f in times}


def busiest_collective_ms(st=None):
    """The busiest rank's ms from reaching "all_reduce" to the end of
    "all_gather": the median over the frames whose rows arrived (the
    ranks' profiler sessions need not start together, so a session's first
    frame can wait up to the others' start); None where none has."""
    got = [v["ranks"][v["busiest"]]["collective_ms"]
           for v in rank_timings(st).values() if v["busiest"] in v["ranks"]]
    return statistics.median(got) if got else None
