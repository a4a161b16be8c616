"""Megakernel-forward gradients (rays1bench_tpu/grad/mega.py, hard mode).

    forward : one launch of the topology kernel (megakernel.trace_topology)
              gives the image and the per-bounce hit topology;
    backward: the derivative of the fixed-trip replay at that topology.

fused=True (the default) runs the backward as one launch of the fused kernel
(kernels/mega_backward.backward), which returns the cotangents of the ten
prepared sphere columns and of the six primary-ray planes. Everything around
the two kernels is plain torch under autograd: raygen
(render.pipeline.primary_rays) chains the ray cotangents onto the camera
tensors, scene.spheres.prepare chains radius_sq and inv_radius onto the
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
exact ones (megakernel.pack_spheres, mega_backward.pack_exact).
"""

from __future__ import annotations

import dataclasses

import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import mega_backward
from rays1bench_tpu_torch.kernels.megakernel import (pack_spheres,
                                                     trace_topology)
from rays1bench_tpu_torch.kernels.pipeline import render_image_topology
from rays1bench_tpu_torch.render.camera import Camera
from rays1bench_tpu_torch.render.pipeline import render_image
from rays1bench_tpu_torch.scene.soa_spheres import SphereSOA
from rays1bench_tpu_torch.scene.spheres import PreparedSpheres

_PREP_FIELDS = tuple(f.name for f in dataclasses.fields(PreparedSpheres))


class _Fused(torch.autograd.Function):
    """Topology kernel forward, fused kernel backward, over the prepared
    sphere columns and the primary rays."""

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
        grads, ray_cts = mega_backward.backward(
            prep, *rays, ray_id, ct_r.contiguous(), ct_g.contiguous(),
            ct_b.contiguous(), topo, ctx.cfg)
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
