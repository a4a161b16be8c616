"""Megakernel-forward gradients (rays1bench_tpu/grad/mega.py).

    forward : one launch of the topology kernel (megakernel.trace_topology)
              gives the image and the per-bounce hit topology;
    backward: the derivative of the fixed-trip replay at that topology.

fused=True (the default) runs the backward as one launch of the fused kernel
(kernels/mega_backward.backward), which returns the cotangents of the ten
prepared sphere columns and of the six primary-ray planes. Around the two
kernels autograd closes the chains: raygen (megakernel.generate_rays, the
raygen kernel on the card, whose backward replays the plain raygen
render.pipeline.primary_rays_from_ids) chains the ray cotangents onto the
camera tensors, scene.spheres.prepare chains radius_sq and inv_radius onto the
signed radius (its safe_r gives placeholder rows exactly 0), and the image's
mean over spp gives each ray the pixel's cotangent / spp. The JAX package
writes those chains by hand (_chain_to_soa, _img_ct_to_slots); here autograd
closes them. Both paths run the forward through
kernels.pipeline.render_image_topology; the fused one passes _Fused to it
as the kernel call.

fused=False is the JAX replay path (_make): the same forward under no_grad,
and the plain replay render.pipeline.render_image(topology=...) added as
replay - replay.detach(), so the value is the kernel's and autograd takes
the replay's derivative. It is the semantic reference, on any device.

The gradient is the exact derivative of the replay render at the recorded
topology; the forward's image uses the kernel's 8-bit albedos, the replay
exact ones (megakernel.pack_spheres, mega_backward.pack_exact). With
cfg.soft_silhouette both paths are soft: the kernel promotes grazes and
draws the two branches, the topology records the promoted rows, and the
fused backward and the replay (promote=False) differentiate the two-branch
estimator at them.

render_image_mega_sharded is the multi-device fused path
(_FusedSharded): each rank of the mesh runs kernel A on its ray
slice (parallel/shard.ray_slice) and the image is all-gathered; in the
backward each rank runs kernel B on the same slice, its ray cotangents
stay local and go through the rank's raygen VJP to the camera, and one
all_reduce a step sums the (10, S) column cotangents and the camera's.
"""

from __future__ import annotations

import dataclasses

import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import mega_backward
from rays1bench_tpu_torch.kernels.megakernel import (CAMERA_FIELDS,
                                                     camera_vjp,
                                                     generate_rays,
                                                     pack_spheres,
                                                     trace_topology)
from rays1bench_tpu_torch.kernels.pipeline import render_image_topology
from rays1bench_tpu_torch.render.camera import Camera
from rays1bench_tpu_torch.render.pipeline import render_image
from rays1bench_tpu_torch.scene.soa_spheres import SphereSOA
from rays1bench_tpu_torch.scene.spheres import PreparedSpheres, prepare
from rays1bench_tpu_torch.utils import profiling

_PREP_FIELDS = tuple(f.name for f in dataclasses.fields(PreparedSpheres))


class _Fused(torch.autograd.Function):
    """Topology kernel forward, fused kernel backward, over the prepared
    sphere columns and the primary rays. While utils/profiling records,
    the backward's launch of kernel B records the span "backward_kernel"
    (on the stream too on a CUDA device)."""

    @staticmethod
    def forward(ctx, cfg, ray_id, *tensors):
        prep = PreparedSpheres(*tensors[:len(_PREP_FIELDS)])
        rays = tensors[len(_PREP_FIELDS):]
        (rr, rg, rb), _, total, topo = trace_topology(pack_spheres(prep),
                                                      *rays, ray_id, cfg)
        ctx.cfg = cfg
        ctx.save_for_backward(ray_id, topo, *tensors)
        ctx.mark_non_differentiable(total, topo)
        return rr, rg, rb, total, topo

    @staticmethod
    def backward(ctx, ct_r, ct_g, ct_b, _total, _topo):
        ray_id, topo, *tensors = ctx.saved_tensors
        prep = PreparedSpheres(*tensors[:len(_PREP_FIELDS)])
        rays = tensors[len(_PREP_FIELDS):]
        ct_r, ct_g, ct_b = (c.contiguous() for c in (ct_r, ct_g, ct_b))
        with profiling.span("backward_kernel", ct_r.is_cuda):
            grads, ray_cts = mega_backward.backward(
                prep, *rays, ray_id, ct_r, ct_g, ct_b, topo, ctx.cfg)
        by_name = dict(zip(mega_backward.GRAD_ROWS, grads))
        prep_cts = tuple(by_name.get(name) for name in _PREP_FIELDS)
        return (None, None) + prep_cts + tuple(ray_cts)


def _fused_trace(prep, ox, oy, oz, dx, dy, dz, ray_id, cfg):
    """render_image_topology's kernel call, through _Fused."""
    rr, rg, rb, total, topo = _Fused.apply(
        cfg, ray_id, *(getattr(prep, f) for f in _PREP_FIELDS),
        ox, oy, oz, dx, dy, dz)
    return (rr, rg, rb), None, total, topo


def render_image_mega(spheres_soa: SphereSOA, camera: Camera,
                      cfg: RenderConfig, fused: bool = True):
    """Differentiable render through the topology kernel forward.

    Same contract as render.pipeline.render_image: (image float32[H, W, 3],
    num_rays int64 0-dim tensor), differentiable with respect to the
    SphereSOA's float columns and the camera tensors. No row trim: pad
    scenes tightly (builders' pad_multiple=8), since every row is swept.
    The kernels run when the tensors are on a CUDA device, their plain
    versions on the CPU."""
    if fused:
        img, total, _ = render_image_topology(spheres_soa, camera, cfg,
                                              trace=_fused_trace)
        return img, total
    with torch.no_grad():
        img, total, topo = render_image_topology(spheres_soa, camera, cfg)
    # The kernel's value, the replay's derivative: replay - replay is 0.
    replay, _ = render_image(spheres_soa, camera,
                             cfg.replace(early_exit=False), topology=topo)
    return img + (replay - replay.detach()), total


def shard_forward(prep: PreparedSpheres, camera: Camera, cfg: RenderConfig,
                  ray_id):
    """Kernel A on one rank's ray slice (parallel/shard.ray_slice), no
    collective: ((rr, rg, rb), cnt, total, topo) of trace_topology on the
    slice's primary rays (megakernel.generate_rays), and those rays."""
    rays = generate_rays(camera, cfg, ray_id)
    return trace_topology(pack_spheres(prep), *rays, ray_id, cfg), rays


class _FusedSharded(torch.autograd.Function):
    """Kernel A on this rank's slice, the radiance all-gathered; kernel B on
    the same slice, with one all_reduce of the column and camera
    cotangents. Inputs: the prepared sphere columns and the camera's
    tensors (the raygen is inside, so that the camera VJP joins the
    all_reduce)."""

    @staticmethod
    def forward(ctx, cfg, mesh, index, ray_id, *tensors):
        from rays1bench_tpu_torch.parallel.shard import (_mesh_group,
                                                         all_gather)
        prep = PreparedSpheres(*tensors[:len(_PREP_FIELDS)])
        camera = Camera(*tensors[len(_PREP_FIELDS):])
        ((rr, rg, rb), _, total, topo), rays = shard_forward(prep, camera,
                                                             cfg, ray_id)
        parts = all_gather(torch.stack([rr, rg, rb]), mesh)
        total = total.clone()
        ctx.group = _mesh_group(mesh)
        torch.distributed.all_reduce(total, group=ctx.group)
        ctx.cfg, ctx.index = cfg, index
        ctx.save_for_backward(ray_id, topo, *rays, *tensors)
        ctx.mark_non_differentiable(total)
        return parts, total

    @staticmethod
    def backward(ctx, ct_parts, _total):
        ray_id, topo, *rest = ctx.saved_tensors
        rays, tensors = rest[:6], rest[6:]
        n_prep = len(_PREP_FIELDS)
        prep = PreparedSpheres(*tensors[:n_prep])
        ct_r, ct_g, ct_b = ct_parts[ctx.index]
        grads, ray_cts = mega_backward.backward(
            prep, *rays, ray_id, ct_r.contiguous(), ct_g.contiguous(),
            ct_b.contiguous(), topo, ctx.cfg)
        need_cam = ctx.needs_input_grad[4 + n_prep:]
        cam_cts = [None] * len(CAMERA_FIELDS)
        if any(need_cam):
            cam_cts = camera_vjp(tensors[n_prep:], ctx.cfg, ray_id, ray_cts,
                                 need_cam)
        live = [c for c in cam_cts if c is not None]
        flat = torch.cat([grads.reshape(-1)] + [c.reshape(-1) for c in live])
        torch.distributed.all_reduce(flat, group=ctx.group)
        sizes = [grads.numel()] + [c.numel() for c in live]
        pieces = iter(flat.split(sizes))
        grads = next(pieces).view_as(grads)
        cam_cts = [None if c is None else next(pieces).view_as(c)
                   for c in cam_cts]
        by_name = dict(zip(mega_backward.GRAD_ROWS, grads))
        prep_cts = tuple(by_name.get(name) for name in _PREP_FIELDS)
        return (None, None, None, None) + prep_cts + tuple(cam_cts)


def render_image_mega_sharded(spheres_soa: SphereSOA, camera: Camera,
                              cfg: RenderConfig, mesh,
                              axis_name: str = "rays"):
    """Differentiable multi-device render through the fused kernels: the
    contract of render_image_mega, with primary rays split over `mesh`'s
    `axis_name` axis (parallel/shard.ray_slice). The image, on every rank,
    equals render_image_mega's bit for bit; gradients match it up to the
    order of float sums (per-rank partial sums, then the all_reduce). A
    loss must be computed from the image on every rank alike: each rank
    keeps its slice of the image's cotangent."""
    from rays1bench_tpu_torch.parallel.mesh import layout
    from rays1bench_tpu_torch.parallel.shard import (_mesh_order,
                                                     assemble_rays,
                                                     ray_slice)
    n_dev, _, d, _ = layout(mesh, axis_name)
    prep = prepare(spheres_soa)
    ray_id = ray_slice(cfg, n_dev, 1, d, 0, spheres_soa.center_x.device)
    parts, total = _FusedSharded.apply(
        cfg, mesh, _mesh_order(mesh).index(torch.distributed.get_rank()),
        ray_id, *(getattr(prep, f) for f in _PREP_FIELDS),
        *(getattr(camera, f) for f in CAMERA_FIELDS))
    return assemble_rays(parts, cfg, (n_dev, 1)), total
