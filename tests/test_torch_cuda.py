"""The port's CUDA kernels on the card, against their plain versions: the
respawn kernel and the topology kernel bit for bit, the fused backward within
GRAD_TOL of backward_reference (float atomics sum its columns in an order
that changes from run to run; its adjoint is derived by hand and orders its
operations otherwise than autograd).

Needs an NVIDIA GPU and nvcc: every test is marked `cuda` and skips without
a CUDA device (the kernels have no CPU mode). This file imports no jax, so it
runs on a machine without it:

    python -m pytest -o addopts= --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad import inverse
from rays1bench_tpu_torch.grad.mega import render_image_mega
from rays1bench_tpu_torch.kernels import mega_backward, megakernel
from rays1bench_tpu_torch.kernels.pipeline import prepare_trimmed, ray_coords
from rays1bench_tpu_torch.render.pipeline import primary_rays
from rays1bench_tpu_torch.scene import builders
from rays1bench_tpu_torch.scene.soa_spheres import SphereSOABuilder
from rays1bench_tpu_torch.scene.spheres import prepare

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

GRAD_TOL = 1e-3
GRAD_CASES = [  # scene, width, height, spp, max_bounces, pad_multiple
    ("small", 64, 32, 2, 3, 8),      # hollow glass, fuzzed metal
    ("small", 64, 32, 2, 5, 8),
    ("medium", 48, 30, 2, 10, 8),    # ragged last block
    ("large", 40, 24, 2, 10, 128),   # 512 rows
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def kernel_and_reference(scene_name, cfg, device, span=None):
    scene = builders.SCENES[scene_name](cfg.aspect, device=device)
    packed = megakernel.pack_spheres(prepare_trimmed(scene.spheres,
                                                     scene.n_real))
    cam = megakernel.pack_camera(scene.camera.build(device))
    before = megakernel.LAUNCHES
    rad, cnt, total = megakernel.trace_respawn(packed, cam, cfg, span)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before + 1
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=device)
    ref, ref_cnt = megakernel.trace_respawn_reference(
        packed, cam, pid, (pid % cfg.width).float(),
        (pid // cfg.width).float(), cfg, span)
    return rad, cnt, total, ref, ref_cnt


@pytest.mark.parametrize("scene,w,h,spp,mb,span", [
    ("medium", 50, 30, 3, 6, None),       # ragged 16x8 blocks
    ("small", 33, 17, 4, 8, (1, 3)),      # hollow glass, a sample slice
    ("giant", 16, 8, 1, 3, None),         # 114,688 B table, > 48 KB
])
def test_kernel_equals_plain_version(cuda, scene, w, h, spp, mb, span):
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb)
    (rr, rg, rb), cnt, total, ref, ref_cnt = kernel_and_reference(
        scene, cfg, cuda, span)
    assert torch.equal(cnt, ref_cnt)
    assert int(total) == int(ref_cnt.sum())
    for a, b in zip((rr, rg, rb), ref):
        assert torch.equal(a, b)


def test_table_above_shared_memory_is_refused(cuda):
    b = SphereSOABuilder()
    for i in range(8400):   # 7 x 4 x 8400 B > 227 KB
        b.add(float(i), 0.0, 0.0, 0.4, 0, 0.5, 0.5, 0.5, 0.0, 1.0)
    packed = megakernel.pack_spheres(prepare_trimmed(b.finalize(8, cuda)))
    cfg = RenderConfig(width=8, height=8, spp=1)
    cam = megakernel.pack_camera(
        builders.create_small_scene(1.0).camera.build(cuda))
    with pytest.raises(ValueError, match="shared memory"):
        megakernel.trace_respawn(packed, cam, cfg)


def grad_inputs(scene_name, w, h, spp, mb, pad, device):
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb, seed=5,
                       early_exit=False)
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=pad,
                                        device=device)
    ray_id, x, y = ray_coords(cfg, device)
    rays = [r.contiguous() for r in primary_rays(
        scene.camera.build(device), cfg, x, y, ray_id)]
    return cfg, scene, prepare(scene.spheres), rays, ray_id


@pytest.mark.parametrize("case", GRAD_CASES)
def test_topology_kernel_equals_plain_version(cuda, case):
    cfg, _, prep, rays, ray_id = grad_inputs(*case, cuda)
    packed = megakernel.pack_spheres(prep)
    before = megakernel.ONESHOT_LAUNCHES
    rad, cnt, total, topo = megakernel.trace_topology(packed, *rays, ray_id,
                                                      cfg)
    torch.cuda.synchronize()
    assert megakernel.ONESHOT_LAUNCHES == before + 1
    ref_rad, ref_cnt, ref_topo = megakernel.trace_topology_reference(
        packed, *rays, ray_id, cfg)
    assert torch.equal(topo, ref_topo) and torch.equal(cnt, ref_cnt)
    assert all(torch.equal(a, b) for a, b in zip(rad, ref_rad))
    assert int(total) == int(cnt.sum())


@pytest.mark.parametrize("case", GRAD_CASES)
def test_fused_backward_matches_backward_reference(cuda, case):
    cfg, scene, prep, rays, ray_id = grad_inputs(*case, cuda)
    _, _, _, topo = megakernel.trace_topology(megakernel.pack_spheres(prep),
                                              *rays, ray_id, cfg)
    g = torch.Generator(device=cuda).manual_seed(3)
    cts = [torch.rand(ray_id.numel(), generator=g, device=cuda) - 0.5
           for _ in range(3)]
    before = mega_backward.LAUNCHES
    grads, ray_cts = mega_backward.backward(prep, *rays, ray_id, *cts, topo,
                                            cfg)
    torch.cuda.synchronize()
    assert mega_backward.LAUNCHES == before + 1
    ref, ref_cts = mega_backward.backward_reference(prep, *rays, ray_id,
                                                    *cts, topo, cfg)
    for a, b in zip(list(grads) + list(ray_cts), list(ref) + list(ref_cts)):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max())
    if grads.shape[1] > scene.n_real:
        assert float(grads[:, scene.n_real:].abs().max()) == 0.0


def test_fit_runs_through_both_kernels(cuda):
    cfg = RenderConfig(width=64, height=32, spp=2, max_bounces=5,
                       early_exit=False)
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8)
    camera = scene.camera.build()
    with torch.no_grad():
        target = inverse.render_for_loss(scene.spheres, camera, cfg)
    start = inverse.with_params(scene.spheres,
                                {"albedo_x": scene.spheres.albedo_x * 0.7})
    a, b = megakernel.ONESHOT_LAUNCHES, mega_backward.LAUNCHES
    fitted, losses = inverse.fit_scene(
        start, camera, target, cfg,
        inverse.InverseConfig(learning_rate=1e-2, steps=3,
                              optimize=("albedo_x",)))
    assert megakernel.ONESHOT_LAUNCHES == a + 3
    assert mega_backward.LAUNCHES == b + 3
    assert losses[-1] < losses[0] and fitted.albedo_x.is_cuda


def test_fused_matches_replay_on_the_card(cuda):
    cfg = RenderConfig(width=48, height=32, spp=2, max_bounces=5,
                       early_exit=False)
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8)
    camera = scene.camera.build()
    grads = []
    for fused in (True, False):
        params = inverse.params_of(scene.spheres, ("center_x", "radius",
                                                   "albedo_y", "ref_idx"))
        img, _ = render_image_mega(inverse.with_params(scene.spheres, params),
                                   camera, cfg, fused=fused)
        torch.mean((img - 0.3) ** 2).backward()
        grads.append({k: v.grad for k, v in params.items()})
    for k, a in grads[0].items():
        b = grads[1][k]
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max())


def test_backward_refuses_what_the_kernel_cannot_take(cuda):
    cfg, _, prep, rays, ray_id = grad_inputs("small", 8, 4, 1, 3, 8, cuda)
    ct = torch.zeros_like(rays[0])
    deep = cfg.replace(max_bounces=mega_backward.MAX_BOUNCES + 1)
    topo = torch.full((deep.max_bounces + 1, ray_id.numel()), -1,
                      dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bounces"):
        mega_backward.backward(prep, *rays, ray_id, ct, ct, ct, topo, deep)
