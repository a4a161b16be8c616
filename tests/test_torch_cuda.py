"""The port's CUDA kernel on the card, against its plain version.

Needs an NVIDIA GPU and nvcc: every test is marked `cuda` and skips without
a CUDA device (the kernel has no CPU mode). This file imports no jax, so it
runs on a machine without it:

    python -m pytest -o addopts= --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import megakernel
from rays1bench_tpu_torch.kernels.pipeline import prepare_trimmed
from rays1bench_tpu_torch.scene import builders
from rays1bench_tpu_torch.scene.soa_spheres import SphereSOABuilder

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


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
