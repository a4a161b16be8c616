"""megakernel.generate_rays, the engines' raygen, on the CPU: its plain
path and its autograd Function.

- On CPU tensors its six planes equal render.pipeline.primary_rays at the
  ids' pixel coordinates bit for bit: a frame in ray-id order, a rank's
  padded slice in a seeded shuffle, an odd size. No kernel launches.
- Autograd records it only where a camera tensor requires grad; the
  camera's gradient through the fused gradient path (render_image_topology
  with grad/mega's kernel call) then equals the one autograd takes through
  primary_rays itself.
- It refuses ids that are not a contiguous int32 vector.

The kernel (csrc/raygen.cu) is held to the same planes on the card
(tests/test_torch_cuda.py) and its lane on the host
(tests/test_torch_host_kernels.py).
"""

import pytest
import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad.mega import render_image_mega
from rays1bench_tpu_torch.kernels import megakernel, pipeline
from rays1bench_tpu_torch.parallel.shard import ray_slice
from rays1bench_tpu_torch.render.camera import build_camera
from rays1bench_tpu_torch.render.pipeline import (primary_rays,
                                                  primary_rays_from_ids)
from rays1bench_tpu_torch.scene import builders

torch.set_num_threads(1)


def ids_of(cfg, case):
    if case == "frame":
        return torch.arange(cfg.num_primary_rays, dtype=torch.int32)
    ray_id = ray_slice(cfg, 4, 1, 3, 0, "cpu")
    perm = torch.randperm(ray_id.numel(),
                          generator=torch.Generator().manual_seed(11))
    return ray_id[perm].contiguous()


@pytest.mark.parametrize("w,h,spp,case", [
    (64, 36, 10, "frame"),
    (161, 93, 3, "frame"),                      # odd size
    (51, 30, 4, "padded slice, shuffled"),      # the last of four ranks
])
def test_generate_rays_on_cpu_equals_primary_rays(w, h, spp, case):
    cfg = RenderConfig(width=w, height=h, spp=spp, seed=2 ** 31 + 77)
    camera = builders.create_large_scene(cfg.aspect,
                                         device="cpu").camera.build("cpu")
    ray_id = ids_of(cfg, case)
    pixel = ray_id // spp
    want = primary_rays(camera, cfg, (pixel % w).float(),
                        (pixel // w).float(), ray_id)
    launches = megakernel.RAYGEN_LAUNCHES
    got = megakernel.generate_rays(camera, cfg, ray_id)
    assert megakernel.RAYGEN_LAUNCHES == launches
    assert len(got) == 6
    assert all(r.is_contiguous() and r.dtype == torch.float32 for r in got)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if case != "frame":
        assert int(ray_id.max()) >= cfg.num_primary_rays


def small_camera(cfg, leaves):
    """The small scene and its camera built from tensors (build_camera);
    lookfrom and vfov are leaves that require grad when `leaves`."""
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8,
                                        device="cpu")
    spec = scene.camera
    lookfrom = torch.tensor(spec.lookfrom, dtype=torch.float32,
                            requires_grad=leaves)
    vfov = torch.tensor(spec.vfov, dtype=torch.float32, requires_grad=leaves)
    camera = build_camera(lookfrom, spec.lookat, spec.vup, vfov, spec.aspect,
                          spec.aperture, spec.focus_dist)
    return scene, camera, (lookfrom, vfov)


def test_without_a_camera_gradient_autograd_records_nothing():
    cfg = RenderConfig(width=16, height=8, spp=2)
    ray_id = ids_of(cfg, "frame")
    _, camera, _ = small_camera(cfg, leaves=False)
    rays = megakernel.generate_rays(camera, cfg, ray_id)
    assert all(r.grad_fn is None and not r.requires_grad for r in rays)
    _, camera, _ = small_camera(cfg, leaves=True)
    rays = megakernel.generate_rays(camera, cfg, ray_id)
    assert all(r.requires_grad for r in rays)
    with torch.no_grad():
        rays = megakernel.generate_rays(camera, cfg, ray_id)
    assert all(r.grad_fn is None for r in rays)


def test_camera_gradient_through_the_function_is_primary_rays(monkeypatch):
    """The camera's gradient on the fused gradient path (kernel A's and
    B's plain versions on the CPU) under an upstream cotangent: through
    generate_rays' Function and, with generate_rays replaced by
    primary_rays_from_ids itself, through autograd over primary_rays. The
    two are equal bit for bit, and not zero."""
    cfg = RenderConfig(width=24, height=12, spp=2, max_bounces=3, seed=9,
                       early_exit=False)
    weights = torch.rand((cfg.height, cfg.width, 3),
                         generator=torch.Generator().manual_seed(4))

    def grads():
        scene, camera, leaves = small_camera(cfg, leaves=True)
        img, _ = render_image_mega(scene.spheres, camera, cfg)
        (img * weights).sum().backward()
        return [t.grad for t in leaves]

    through_function = grads()
    monkeypatch.setattr(pipeline, "generate_rays", primary_rays_from_ids)
    through_torch = grads()
    assert all(torch.equal(a, b)
               for a, b in zip(through_function, through_torch))
    assert all(bool(g.abs().sum() > 0) for g in through_function)


@pytest.mark.parametrize("bad", ["int64", "2-D", "strided"])
def test_generate_rays_refuses_ids_it_cannot_take(bad):
    cfg = RenderConfig(width=8, height=4, spp=2)
    camera = builders.create_small_scene(cfg.aspect,
                                         device="cpu").camera.build("cpu")
    ray_id = torch.arange(cfg.num_primary_rays * 2, dtype=torch.int32)
    ray_id = {"int64": ray_id.long(), "2-D": ray_id.reshape(2, -1),
              "strided": ray_id[::2]}[bad]
    with pytest.raises(ValueError):
        megakernel.generate_rays(camera, cfg, ray_id)
