"""The port's CUDA kernels on the card, against their plain versions: the
respawn, topology, one-shot, index and phase kernels bit for bit, the fused
backward within GRAD_TOL of backward_reference (float atomics sum its
columns in an order that changes from run to run; its adjoint is derived by
hand and orders its operations otherwise than autograd). The topology
kernel and the fused backward in their soft-silhouette mode too; there the
raw inv_radius column is rounding noise (the soft normal is renormalized,
so its exact derivative is 0) and the check chains the columns onto the
scene's own through scene/spheres.prepare instead.

Needs an NVIDIA GPU and nvcc: every test is marked `cuda` and skips without
a CUDA device (the kernels have no CPU mode). This file imports no jax, so it
runs on a machine without it:

    python -m pytest -o addopts= --noconftest tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad import inverse
from rays1bench_tpu_torch.grad.mega import render_image_mega
from rays1bench_tpu_torch.kernels import (intersect_index, mega_backward,
                                         megakernel)
from rays1bench_tpu_torch.kernels.pipeline import (frame_ray_ids,
                                                   prepare_trimmed,
                                                   render_image_megakernel)
from rays1bench_tpu_torch.render.camera import CameraSpec
from rays1bench_tpu_torch.render.pipeline import (primary_rays,
                                                  primary_rays_from_ids,
                                                  render_image)
from rays1bench_tpu_torch.scene import builders
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS, SphereSOABuilder
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
    ("small", 50, 30, 4, 6, (2, 2)),      # ragged, an empty span
    ("small", 50, 30, 4, 6, (3, 4)),      # ragged, a one-sample span
    ("giant", 50, 30, 2, 4, None),        # the giant table, ragged warps
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


def grad_inputs(scene_name, w, h, spp, mb, pad, device, soft=0.0):
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb, seed=5,
                       early_exit=False, soft_silhouette=soft)
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=pad,
                                        device=device)
    ray_id = frame_ray_ids(cfg, device)
    rays = [r.contiguous() for r in primary_rays_from_ids(
        scene.camera.build(device), cfg, ray_id)]
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


def backward_against_reference(cfg, soa, rays, ray_id, device):
    """The fused backward on these rays, at the topology the topology kernel
    records for them, against backward_reference: every column and ray
    plane within GRAD_TOL, all finite, placeholder rows exactly 0. Returns
    the topology."""
    prep = prepare(soa)
    _, _, _, topo = megakernel.trace_topology(megakernel.pack_spheres(prep),
                                              *rays, ray_id, cfg)
    g = torch.Generator(device=device).manual_seed(5)
    cts = [torch.rand(ray_id.numel(), generator=g, device=device) - 0.5
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
    real = int((soa.radius != 0).sum())
    if grads.shape[1] > real:
        assert float(grads[:, real:].abs().max()) == 0.0
    return topo


@pytest.mark.parametrize("case", GRAD_CASES)
def test_fused_backward_matches_backward_reference(cuda, case):
    cfg, scene, _, rays, ray_id = grad_inputs(*case, cuda)
    backward_against_reference(cfg, scene.spheres, rays, ray_id, cuda)


def test_fused_backward_when_every_ray_hits_one_row(cuda):
    """The ground alone, padded to 8 rows, under a camera looking straight
    down: every hit is row 0, so every warp sums one row (the butterfly)."""
    cfg = RenderConfig(width=64, height=32, spp=2, max_bounces=4, seed=5,
                       early_exit=False)
    b = SphereSOABuilder()
    b.add(0.0, -100.5, -1.0, 100.0, 0, 0.8, 0.8, 0.0, 0.0, 1.0)
    soa = b.finalize(8, cuda)
    camera = CameraSpec(lookfrom=(0, 3, -1), lookat=(0, 0, -1),
                        vup=(0, 0, -1), aspect=cfg.aspect).build(cuda)
    ray_id = frame_ray_ids(cfg, cuda)
    rays = [r.contiguous() for r in primary_rays_from_ids(camera, cfg, ray_id)]
    topo = backward_against_reference(cfg, soa, rays, ray_id, cuda)
    assert bool((topo[0] == 0).all()) and int(topo.max()) == 0


def test_fused_backward_on_distinct_rows(cuda):
    """The 512-row table with rays from seeded random origins and
    directions: the lanes of a warp hit many distinct rows (the grouped
    tree sums)."""
    cfg = RenderConfig(width=100, height=100, spp=2, max_bounces=10, seed=5,
                       early_exit=False)
    soa = builders.create_large_scene(cfg.aspect, pad_multiple=128,
                                      device=cuda).spheres
    n = cfg.num_primary_rays
    g = torch.Generator(device=cuda).manual_seed(11)
    o = (torch.rand((3, n), generator=g, device=cuda) * 2 - 1) * 8
    o[1] = torch.rand(n, generator=g, device=cuda) * 0.5 + 0.3
    d = torch.randn((3, n), generator=g, device=cuda)
    d = d / d.norm(dim=0)
    ray_id = torch.arange(n, dtype=torch.int32, device=cuda)
    rays = [r.contiguous() for r in (*o, *d)]
    topo = backward_against_reference(cfg, soa, rays, ray_id, cuda)
    rows = topo[0][topo[0] >= 0]
    assert rows.unique().numel() > 256


@pytest.mark.parametrize("mb", [10, 11, 50])
def test_fused_backward_depth_caps(cuda, mb):
    """Both checkpoint depths of the kernel: max_bounces up to 10 runs the
    shallow instantiation, 11 and 50 the deep one; hollow glass keeps paths
    alive past 10 bounces."""
    cfg, scene, prep, rays, ray_id = grad_inputs("small", 48, 32, 2, mb, 8,
                                                 cuda)
    topo = backward_against_reference(cfg, scene.spheres, rays, ray_id, cuda)
    if mb > 10:
        assert bool((topo[10] >= 0).any())


def test_fit_frame_band_through_both_kernels(cuda):
    """An 8-row band across the middle of the albedo fit's frame at the
    reference's size (1280x720 @ 32 spp @ 50 bounces, the large scene's
    512 rows; 327,680 primary rays): kernel A's image, counts and 51
    topology planes equal trace_topology_reference's bit for bit, and
    kernel B's cap-50 instantiation is within GRAD_TOL of the plain replay
    at that topology, with paths that live past the shallow cap."""
    cfg = RenderConfig(width=1280, height=720, spp=32, max_bounces=50,
                       seed=5, early_exit=False)
    scene = builders.create_large_scene(cfg.aspect, pad_multiple=128,
                                        device=cuda)
    lo, hi = 356 * cfg.width * cfg.spp, 364 * cfg.width * cfg.spp
    ray_id = torch.arange(lo, hi, dtype=torch.int32, device=cuda)
    rays = [r.contiguous() for r in primary_rays_from_ids(
        scene.camera.build(cuda), cfg, ray_id)]
    packed = megakernel.pack_spheres(prepare(scene.spheres))
    rad, cnt, total, topo = megakernel.trace_topology(packed, *rays, ray_id,
                                                      cfg)
    ref_rad, ref_cnt, ref_topo = megakernel.trace_topology_reference(
        packed, *rays, ray_id, cfg)
    assert torch.equal(topo, ref_topo) and torch.equal(cnt, ref_cnt)
    assert all(torch.equal(a, b) for a, b in zip(rad, ref_rad))
    assert int(total) == int(cnt.sum(dtype=torch.int64))
    del ref_rad, ref_cnt, ref_topo
    topo = backward_against_reference(cfg, scene.spheres, rays, ray_id, cuda)
    assert bool((topo[11] >= 0).any())


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


def test_oneshot_kernel_equals_topology_kernel(cuda):
    """trace_oneshot (no topology planes) gives the topology kernel's
    radiance and counts."""
    cfg, _, prep, rays, ray_id = grad_inputs("small", 50, 30, 3, 6, 8, cuda)
    packed = megakernel.pack_spheres(prep)
    before = megakernel.ONESHOT_LAUNCHES
    rad, cnt, total = megakernel.trace_oneshot(packed, *rays, ray_id, cfg)
    ref_rad, ref_cnt, ref_total, _ = megakernel.trace_topology(
        packed, *rays, ray_id, cfg)
    torch.cuda.synchronize()
    assert megakernel.ONESHOT_LAUNCHES == before + 2
    assert torch.equal(cnt, ref_cnt) and int(total) == int(ref_total)
    assert all(torch.equal(a, b) for a, b in zip(rad, ref_rad))


def oneshot_against_reference(packed, rays, ray_id, cfg):
    """The topology kernel on these rays, held bit for bit against its
    plain version; returns the per-ray counts."""
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
    return cnt


@pytest.mark.parametrize("case", ["N=1", "N=33", "all sky", "all padding",
                                  "giant table"])
def test_oneshot_kernel_edge_cases(cuda, case):
    """One ray; a warp and one; rays that all miss at their first segment;
    a list of padding ids only (never traced): on the small scene's 8 rows,
    the per-ray nest; and the giant scene's 4,096-row table (114,688 B,
    > 48 KB) through the flat loop."""
    scene = "giant" if case == "giant table" else "small"
    cfg, _, prep, rays, ray_id = grad_inputs(scene, 32, 16, 2, 6, 8, cuda)
    packed = megakernel.pack_spheres(prep)
    if case in ("N=1", "N=33"):
        n = int(case[2:])
        rays, ray_id = [r[:n].contiguous() for r in rays], ray_id[:n]
    elif case == "all sky":
        rays = rays[:3] + [torch.zeros_like(rays[0]), torch.ones_like(
            rays[0]), torch.zeros_like(rays[0])]
    elif case == "all padding":
        ray_id = ray_id + cfg.num_primary_rays
    cnt = oneshot_against_reference(packed, rays, ray_id, cfg)
    if case == "all sky":
        assert bool((cnt == 1).all())
    if case == "all padding":
        assert int(cnt.abs().sum()) == 0


@pytest.mark.parametrize("soft", [0.0, 0.005])
def test_oneshot_topology_tails_when_lanes_refill(cuda, soft):
    """Rays of many depths in a seeded order, so that the lanes of a warp
    refill at different bounces (the medium scene's 48 rows take the flat
    loop): every topology plane, the tails past each ray's end included,
    equals the plain version's."""
    cfg, _, prep, rays, ray_id = grad_inputs("medium", 64, 32, 2, 8, 8, cuda,
                                             soft)
    perm = torch.randperm(ray_id.numel(), device=cuda,
                          generator=torch.Generator(cuda).manual_seed(4))
    cnt = oneshot_against_reference(
        megakernel.pack_spheres(prep), [r[perm].contiguous() for r in rays],
        ray_id[perm].contiguous(), cfg)
    assert len(torch.unique(cnt)) >= 4


@pytest.mark.parametrize("scene,pad,n", [("small", 8, 777),
                                         ("large", 128, 20_000),
                                         ("giant", 128, 3_001)])
def test_index_kernel_equals_plain_version(cuda, scene, pad, n):
    """Random rays, some with zero directions; the giant table (65,536 B)
    needs the shared-memory opt-in."""
    soa = builders.SCENES[scene](16 / 9, pad_multiple=pad, device=cuda).spheres
    prep = prepare(soa)
    g = torch.Generator(device=cuda).manual_seed(n)
    o = (torch.rand((3, n), generator=g, device=cuda) * 2 - 1) * 6
    o[1] = o[1].abs() + 0.2
    d = torch.randn((3, n), generator=g, device=cuda)
    d = d / d.norm(dim=0)
    d[:, ::50] = 0.0
    before = intersect_index.LAUNCHES
    idx, hit = intersect_index.closest_hit_index(prep, *o, *d, 1e-3)
    torch.cuda.synchronize()
    assert intersect_index.LAUNCHES == before + 1
    ref_idx, ref_hit = intersect_index.closest_hit_index_reference(
        intersect_index.pack(prep), *o, *d, 1e-3)
    assert torch.equal(idx, ref_idx) and torch.equal(hit, ref_hit)
    assert 0 < int(hit.sum()) < n


def sliced(prep, rows):
    return dataclasses.replace(prep, **{
        f.name: getattr(prep, f.name)[:rows].contiguous()
        for f in dataclasses.fields(prep)})


@pytest.mark.parametrize("rows", [1000, 1024, 1025, 4096])
def test_index_kernel_across_tiles(cuda, rows):
    """The giant scene's first rows, below, at and above one 1,024-row tile
    of the kernel's shared memory, and all 4,096: the first minimum over
    the tiles, bit for bit."""
    soa = builders.SCENES["giant"](16 / 9, pad_multiple=8,
                                   device=cuda).spheres
    prep = sliced(prepare(soa), rows)
    g = torch.Generator(device=cuda).manual_seed(rows)
    o = (torch.rand((3, 5000), generator=g, device=cuda) * 2 - 1) * 6
    o[1] = o[1].abs() + 0.2
    d = torch.randn((3, 5000), generator=g, device=cuda)
    d = d / d.norm(dim=0)
    idx, hit = intersect_index.closest_hit_index(prep, *o, *d, 1e-3)
    ref_idx, ref_hit = intersect_index.closest_hit_index_reference(
        intersect_index.pack(prep), *o, *d, 1e-3)
    assert torch.equal(idx, ref_idx) and torch.equal(hit, ref_hit)
    assert 0 < int(hit.sum()) < 5000
    if rows > 1024:
        assert int(idx.max()) >= 1024


def test_index_call_launches_no_torch_op(cuda):
    """On a CUDA tensor closest_hit_index launches its own kernel and
    nothing else: the kernel builds its table from the prepared columns."""
    from torch.profiler import ProfilerActivity, profile

    from rays1bench_tpu_torch.bench.grad import is_kernel
    prep = prepare(builders.SCENES["medium"](16 / 9, pad_multiple=8,
                                             device=cuda).spheres)
    o = torch.rand((3, 4096), device=cuda) * 4 - 2
    d = torch.randn((3, 4096), device=cuda)
    d = d / d.norm(dim=0)
    o[1] = o[1].abs() + 0.2
    rays = [r.contiguous() for r in (*o, *d)]
    intersect_index.closest_hit_index(prep, *rays, 1e-3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        intersect_index.closest_hit_index(prep, *rays, 1e-3)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all(is_kernel(n, "index_kernel") for n in names), names


@pytest.mark.parametrize("mb,schedule", [(6, (2, 5)), (3, (2, 3, 6)),
                                         (6, (1,)), (4, (4, 7))])
def test_phase_kernel_equals_plain_version(cuda, mb, schedule):
    """Each phase from the same state, kernel and plain version, equal bit
    for bit; the whole wavefront trace equals the one-shot kernel's."""
    cfg, _, prep, rays, ray_id = grad_inputs("small", 40, 24, 4, mb, 8, cuda)
    packed = megakernel.pack_spheres(prep)
    state, alive, cnt = megakernel.wavefront_state(*rays, ray_id, cfg)
    before = megakernel.PHASE_LAUNCHES
    spans = megakernel.wavefront_spans(schedule, mb)
    for k, (b0, bend) in enumerate(spans):
        slots = alive.nonzero()[:, 0].to(torch.int32) if k else None
        ref = [t.clone() for t in (state, alive, cnt)]
        megakernel.wavefront_phase_reference(packed, *ref[:2], ray_id,
                                             ref[2], slots, b0, bend, cfg)
        megakernel.wavefront_phase(packed, state, alive, ray_id, cnt, slots,
                                   b0, bend, cfg)
        torch.cuda.synchronize()
        assert torch.equal(state, ref[0]) and torch.equal(alive, ref[1])
        assert torch.equal(cnt, ref[2])
    assert megakernel.PHASE_LAUNCHES - before == len(spans)
    rad, w_cnt, total = megakernel.trace_wavefront(packed, *rays, ray_id, cfg,
                                                   schedule)
    o_rad, o_cnt, o_total = megakernel.trace_oneshot(packed, *rays, ray_id,
                                                     cfg)
    assert torch.equal(w_cnt, o_cnt) and int(total) == int(o_total)
    assert all(torch.equal(a, b) for a, b in zip(rad, o_rad))


@pytest.mark.parametrize("case,scene", [
    ("M=1", "small"), ("M=1", "medium"), ("M=33", "small"),
    ("M=33", "medium"), ("all dead", "small"), ("all dead", "medium"),
    ("seeded order", "small"), ("seeded order", "medium"),
    ("giant table", "giant"), ("M=0", "medium"),
])
def test_phase_kernel_edge_cases(cuda, case, scene):
    """The second phase's list cut to one entry or a warp and one, a list
    of dead rays only, the live rays in a seeded order, the giant scene's
    4,096-row table (114,688 B of shared memory) and an empty list, which
    launches nothing: state, alive flags and counts equal to the plain
    version's after both phases. The small scene's 8 rows take the per-ray
    nest, 48 rows and up the flat loop."""
    cfg, _, prep, rays, ray_id = grad_inputs(scene, 32, 16, 2, 6, 8, cuda)
    packed = megakernel.pack_spheres(prep)
    state, alive, cnt = megakernel.wavefront_state(*rays, ray_id, cfg)
    ref = [t.clone() for t in (state, alive, cnt)]
    megakernel.wavefront_phase_reference(packed, *ref[:2], ray_id, ref[2],
                                         None, 0, 2, cfg)
    megakernel.wavefront_phase(packed, state, alive, ray_id, cnt, None, 0, 2,
                               cfg)
    torch.cuda.synchronize()
    assert torch.equal(state, ref[0]) and torch.equal(alive, ref[1])
    assert torch.equal(cnt, ref[2])
    live = alive.nonzero()[:, 0].to(torch.int32)
    if case in ("M=1", "M=33"):
        slots = live[:int(case[2:])]
    elif case == "all dead":
        slots = (~alive).nonzero()[:, 0].to(torch.int32)
    elif case == "seeded order":
        slots = live[torch.randperm(live.numel(), device=cuda,
                                    generator=torch.Generator(
                                        cuda).manual_seed(6))]
    else:
        slots = live[:0] if case == "M=0" else live
    assert slots.numel() > 0 or case == "M=0"
    before_state = state.clone()
    ref = [t.clone() for t in (state, alive, cnt)]
    megakernel.wavefront_phase_reference(packed, *ref[:2], ray_id, ref[2],
                                         slots.contiguous(), 2, 7, cfg)
    before = megakernel.PHASE_LAUNCHES
    megakernel.wavefront_phase(packed, state, alive, ray_id, cnt,
                               slots.contiguous(), 2, 7, cfg)
    torch.cuda.synchronize()
    assert megakernel.PHASE_LAUNCHES - before == (case != "M=0")
    assert torch.equal(state, ref[0]) and torch.equal(alive, ref[1])
    assert torch.equal(cnt, ref[2])
    if case in ("all dead", "M=0"):
        assert torch.equal(state, before_state)


def test_render_engines_agree_on_the_card(cuda):
    cfg = RenderConfig(width=48, height=32, spp=4, max_bounces=8)
    scene = builders.create_small_scene(cfg.aspect)
    camera = scene.camera.build()
    one, n_one = render_image_megakernel(scene.spheres, camera, cfg,
                                         scene.n_real, respawn=False)
    wave, n_wave = render_image_megakernel(scene.spheres, camera, cfg,
                                           scene.n_real, respawn=False,
                                           wavefront=(2, 3, 6))
    resp, n_resp = render_image_megakernel(scene.spheres, camera, cfg,
                                           scene.n_real)
    assert torch.equal(one, wave) and int(n_one) == int(n_wave)
    assert int(n_one) == int(n_resp)
    assert float((one - resp).abs().max()) <= 1e-5


def test_pipeline_gradient_same_with_index_kernel(cuda):
    """engine="pipeline": the index kernel or the plain sweep as the
    pipeline's intersector give the same image and gradients bit for bit;
    the forward launches the index kernel once a bounce, the backward
    never."""
    cfg = RenderConfig(width=48, height=32, spp=2, max_bounces=5,
                       early_exit=False, ray_chunk=1024)
    scene = builders.create_medium_scene(cfg.aspect, pad_multiple=8)
    camera = scene.camera.build()
    out = []
    for pallas in (False, True):
        params = inverse.params_of(scene.spheres, ("center_x", "radius",
                                                   "albedo_y"))
        before = intersect_index.LAUNCHES
        img, n = render_image(inverse.with_params(scene.spheres, params),
                              camera, cfg.replace(pallas_intersect=pallas))
        forward = intersect_index.LAUNCHES - before
        torch.mean((img - 0.3) ** 2).backward()
        assert intersect_index.LAUNCHES - before == forward
        out.append((img, int(n), forward,
                    {k: v.grad for k, v in params.items()}))
    chunks = -(-cfg.num_primary_rays // cfg.ray_chunk)
    assert out[0][2] == 0 and out[1][2] == chunks * (cfg.max_bounces + 1)
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]
    for k, g in out[0][3].items():
        assert torch.equal(g, out[1][3][k]), k


SOFT_CASES = [  # scene, width, height, spp, max_bounces, pad_multiple
    ("small", 64, 32, 2, 4, 8),      # hollow glass
    ("small", 50, 30, 2, 4, 8),      # ragged last block
    ("medium", 48, 30, 2, 10, 8),
]


@pytest.mark.parametrize("case", SOFT_CASES)
def test_soft_topology_kernel_equals_plain_version(cuda, case):
    cfg, _, prep, rays, ray_id = grad_inputs(*case, cuda, soft=0.005)
    packed = megakernel.pack_spheres(prep)
    before = megakernel.ONESHOT_LAUNCHES
    rad, cnt, total, topo = megakernel.trace_topology(packed, *rays, ray_id,
                                                      cfg)
    torch.cuda.synchronize()
    assert megakernel.ONESHOT_LAUNCHES == before + 1
    stats = {}
    ref_rad, ref_cnt, ref_topo = megakernel.trace_topology_reference(
        packed, *rays, ray_id, cfg, stats=stats)
    assert torch.equal(topo, ref_topo) and torch.equal(cnt, ref_cnt)
    assert all(torch.equal(a, b) for a, b in zip(rad, ref_rad))
    assert int(total) == int(cnt.sum())
    assert stats["promoted"] > 0 and stats["pass_through"] > 0
    rad1, cnt1, _ = megakernel.trace_oneshot(packed, *rays, ray_id, cfg)
    assert torch.equal(cnt1, cnt) and all(torch.equal(a, b)
                                          for a, b in zip(rad1, rad))


def soa_grads(soa, grads):
    """Chain GRAD_ROWS cotangents onto the scene's float columns."""
    floats = [c for c in COLUMNS if c != "mat_type"]
    soa = dataclasses.replace(soa, **{
        c: getattr(soa, c).detach().clone().requires_grad_(True)
        for c in floats})
    prep = prepare(soa)
    torch.autograd.backward(
        [getattr(prep, n) for n in mega_backward.GRAD_ROWS], list(grads))
    return [getattr(soa, c).grad for c in floats]


@pytest.mark.parametrize("case", SOFT_CASES)
def test_soft_fused_backward_matches_backward_reference(cuda, case):
    cfg, scene, prep, rays, ray_id = grad_inputs(*case, cuda, soft=0.005)
    _, _, _, topo = megakernel.trace_topology(megakernel.pack_spheres(prep),
                                              *rays, ray_id, cfg)
    g = torch.Generator(device=cuda).manual_seed(4)
    cts = [torch.rand(ray_id.numel(), generator=g, device=cuda) - 0.5
           for _ in range(3)]
    before = mega_backward.LAUNCHES
    grads, ray_cts = mega_backward.backward(prep, *rays, ray_id, *cts, topo,
                                            cfg)
    torch.cuda.synchronize()
    assert mega_backward.LAUNCHES == before + 1
    ref, ref_cts = mega_backward.backward_reference(prep, *rays, ray_id,
                                                    *cts, topo, cfg)
    noise = mega_backward.GRAD_ROWS.index("inv_radius")
    pairs = ([(grads[k], ref[k]) for k in range(len(ref)) if k != noise]
             + list(zip(ray_cts, ref_cts))
             + list(zip(soa_grads(scene.spheres, grads),
                        soa_grads(scene.spheres, ref))))
    for a, b in pairs:
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max())
    if grads.shape[1] > scene.n_real:
        assert float(grads[:, scene.n_real:].abs().max()) == 0.0


def test_soft_fit_launches_each_kernel_twice_a_step(cuda):
    """The U-statistic loss renders twice: a soft step launches the
    topology kernel and the fused backward twice each."""
    cfg = RenderConfig(width=64, height=32, spp=2, max_bounces=5,
                       early_exit=False, seed=3, soft_silhouette=0.005)
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8)
    camera = scene.camera.build()
    with torch.no_grad():
        target = inverse.render_for_loss(scene.spheres, camera, cfg)
    start = inverse.with_params(
        scene.spheres, {"center_x": scene.spheres.center_x + 0.03})
    a, b = megakernel.ONESHOT_LAUNCHES, mega_backward.LAUNCHES
    fitted, losses = inverse.fit_scene(
        start, camera, target, cfg,
        inverse.InverseConfig(learning_rate=2e-3, steps=3,
                              optimize=("center_x", "center_y", "radius")),
        engine="mega")
    assert megakernel.ONESHOT_LAUNCHES == a + 6
    assert mega_backward.LAUNCHES == b + 6
    assert bool(torch.isfinite(torch.tensor(losses)).all())
    assert fitted.center_x.is_cuda


@pytest.mark.parametrize("scene,w,h,spp,mb,span", [
    ("small", 50, 30, 4, 6, None),       # ragged 8x4 warps
    ("large", 64, 40, 3, 10, (1, 3)),    # 512 rows, a sample slice
])
def test_respawn_trips_equal_the_plain_twin(cuda, scene, w, h, spp, mb,
                                            span):
    """The kIters instantiation: the same radiance, counts and total as the
    kernel without it, and trips equal to respawn_iters_reference of its
    own per-pixel counts (each 8x4-pixel warp runs its busiest pixel's
    segments)."""
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb)
    s = builders.SCENES[scene](cfg.aspect, device=cuda)
    packed = megakernel.pack_spheres(prepare_trimmed(s.spheres, s.n_real))
    cam = megakernel.pack_camera(s.camera.build(cuda))
    before = megakernel.RESPAWN_ITERS_LAUNCHES
    rad, cnt, total, iters = megakernel.trace_respawn(packed, cam, cfg, span,
                                                      debug_iters=True)
    ref_rad, ref_cnt, ref_total = megakernel.trace_respawn(packed, cam, cfg,
                                                           span)
    torch.cuda.synchronize()
    assert megakernel.RESPAWN_ITERS_LAUNCHES == before + 1
    assert torch.equal(cnt, ref_cnt) and int(total) == int(ref_total)
    assert all(torch.equal(a, b) for a, b in zip(rad, ref_rad))
    assert int(iters) == int(megakernel.respawn_iters_reference(cnt, w))


@pytest.mark.parametrize("scene,soft", [("small", 0.0), ("small", 0.005),
                                        ("medium", 0.0), ("medium", 0.005)])
def test_oneshot_trips(cuda, scene, soft):
    """The kIters instantiations give the radiance, counts and total of the
    kernel without them. Below 16 rows (small: a thread per ray) the trips
    equal oneshot_iters_reference; from 16 rows up (medium: the flat loop)
    they depend on the refill order and are held to its bound: 32 x trips
    >= the segments traced (occupancy <= 1)."""
    cfg, _, prep, rays, ray_id = grad_inputs(scene, 64, 32, 2, 8, 8, cuda,
                                             soft)
    packed = megakernel.pack_spheres(prep)
    rad, cnt, total, iters = megakernel.trace_oneshot(packed, *rays, ray_id,
                                                      cfg, debug_iters=True)
    ref_rad, ref_cnt, ref_total = megakernel.trace_oneshot(packed, *rays,
                                                           ray_id, cfg)
    torch.cuda.synchronize()
    assert torch.equal(cnt, ref_cnt) and int(total) == int(ref_total)
    assert all(torch.equal(a, b) for a, b in zip(rad, ref_rad))
    plain = int(megakernel.oneshot_iters_reference(cnt, packed.shape[1]))
    if packed.shape[1] < megakernel.NEST_ROWS:
        assert int(iters) == plain
    else:
        assert int(iters) >= plain and 32 * int(iters) >= int(total)


@pytest.mark.parametrize("sets", [
    ((0, 8), (8, 24), (24, 30), (30, 30)),              # contiguous bands
    ((0, 30, 2), (8, 30, 2)),                           # 2 ranks
    ((0, 30, 3), (8, 30, 3), (16, 30, 3)),              # 3 ranks, ragged
    ((0, 30, 4), (8, 30, 4), (16, 30, 4), (24, 30, 4)),  # 4 ranks
    ((30, 30, 8), (0, 20, 2)),                          # empty; cut at y_hi
], ids=["bands", "stride2", "stride3", "stride4", "cut"])
def test_respawn_band_equals_rows_of_the_frame(cuda, sets):
    """Sets of 8-row blocks, contiguous bands or every stride-th block
    (a rank of the sharded split), give those rows of the whole frame bit
    for bit in image order, and the trips of a split's sets sum to the
    frame's (each set's warps are the frame's)."""
    cfg = RenderConfig(width=50, height=30, spp=3, max_bounces=6)
    s = builders.create_medium_scene(cfg.aspect, device=cuda)
    packed = megakernel.pack_spheres(prepare_trimmed(s.spheres, s.n_real))
    cam = megakernel.pack_camera(s.camera.build(cuda))
    rad, cnt, total, iters = megakernel.trace_respawn(packed, cam, cfg,
                                                      debug_iters=True)
    trips, traced = 0, []
    for rows in sets:
        b_rad, b_cnt, b_total, b_iters = megakernel.trace_respawn(
            packed, cam, cfg, rows=rows, debug_iters=True)
        ys = megakernel.block_rows(cfg, rows).to(cuda)
        pix = (ys[:, None] * cfg.width
               + torch.arange(cfg.width, device=cuda)).reshape(-1)
        assert torch.equal(b_cnt, cnt[pix]), rows
        assert all(torch.equal(a, b[pix]) for a, b in zip(b_rad, rad)), rows
        assert int(b_total) == int(cnt[pix].sum())
        assert int(b_iters) == int(megakernel.respawn_iters_reference(
            b_cnt, cfg.width))
        trips += int(b_iters)
        traced += ys.tolist()
    if sorted(traced) == list(range(cfg.height)):
        assert trips == int(iters)


def test_sharded_render_in_a_group_of_one(cuda, tmp_path):
    """A 1-rank NCCL group: each engine through render_image_pallas_sharded
    (with telemetry where the engine has a counter) and the plain engine
    through render_image_sharded give the single-device images bit for
    bit."""
    import torch.distributed as dist

    from rays1bench_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
    from rays1bench_tpu_torch.parallel.shard import (
        render_image_pallas_sharded, render_image_sharded)

    cfg = RenderConfig(width=48, height=32, spp=4, max_bounces=8)
    s = builders.create_medium_scene(cfg.aspect, device=cuda)
    camera = s.camera.build(cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device=cuda)
        for kw in (dict(respawn=False), dict(respawn=True),
                   dict(respawn=False, wavefront=(2, 3, 6))):
            want, n_want = render_image_megakernel(s.spheres, camera, cfg,
                                                   s.n_real, **kw)
            telem = "wavefront" not in kw
            out = render_image_pallas_sharded(s.spheres, camera, cfg, mesh,
                                              n_real=s.n_real,
                                              telemetry=telem, **kw)
            assert torch.equal(out[0], want) and int(out[1]) == int(n_want)
            if telem:
                assert int(out[2]["device_rays"].sum()) == int(n_want)
                assert int(out[2]["device_iters"].sum()) > 0
        img, n = render_image_pallas_sharded(
            s.spheres, camera, cfg, make_mesh2d(1, 1, device=cuda),
            axis_name="tiles", sample_axis="samples", n_real=s.n_real)
        want, n_want = render_image_megakernel(s.spheres, camera, cfg,
                                               s.n_real, respawn=False)
        assert torch.equal(img, want) and int(n) == int(n_want)
        img, n = render_image_sharded(s.spheres, camera, cfg, mesh)
        want, n_want = render_image(s.spheres, camera, cfg)
        assert torch.equal(img, want) and int(n) == int(n_want)
    finally:
        dist.destroy_process_group()


# A span's host interval against the profiler's events (µs), and its
# stream ms against the kernel's device time (relative).
SPAN_AXIS_US = 50.0
SPAN_STREAM_REL = 0.05
# The spans of a respawn frame (render_image_megakernel).
FRAME_SPANS = {"frame", "prepare", "kernel", "reduce"}


def test_a_span_agrees_with_the_profilers_device_events(cuda):
    """On the trace's axis (time.time_ns(), the profiler's clock) a span
    around a respawn launch and synchronize() holds the kernel's launch
    and its device interval; its stream ms is the kernel's device time;
    no span is recorded as a device event, there or in a profiled
    frame."""
    from torch.profiler import ProfilerActivity, profile

    from rays1bench_tpu_torch.utils import profiling

    cfg = RenderConfig(width=1280, height=720, spp=16, max_bounces=50)
    s = builders.create_large_scene(cfg.aspect, device=cuda)
    packed = megakernel.pack_spheres(prepare_trimmed(s.spheres, s.n_real))
    cam = megakernel.pack_camera(s.camera.build(cuda))
    megakernel.trace_respawn(packed, cam, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.span("probe", device=True) as sp:
            megakernel.trace_respawn(packed, cam, cfg)
            torch.cuda.synchronize()
        render_image_megakernel(s.spheres, s.camera.build(cuda), cfg,
                                n_real=s.n_real)
        torch.cuda.synchronize()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    lo, hi = (sp.start_ns - t0) / 1e3, (sp.end_ns - t0) / 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel = min((e for e in dev if "respawn_kernel" in e.name),
                 key=lambda e: e.time_range.start)
    launch = max((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith(("cudaLaunchKernel",
                                         "cuLaunchKernel"))
                  and e.time_range.start <= kernel.time_range.start),
                 key=lambda e: e.time_range.start)
    for e in (launch, kernel):
        assert lo - SPAN_AXIS_US <= e.time_range.start
        assert e.time_range.end <= hi + SPAN_AXIS_US
    device_ms = (kernel.time_range.end - kernel.time_range.start) / 1e3
    assert abs(sp.stream_ms - device_ms) <= SPAN_STREAM_REL * device_ms
    assert not ({e.name for e in dev} & (FRAME_SPANS | {"probe"}))
    assert {x.name for x in profiling.spans()} == FRAME_SPANS | {"probe"}


def test_sharded_frames_carry_their_times_in_a_group_of_one(cuda,
                                                            tmp_path):
    """Recording, a 1-rank NCCL group's telemetry rows carry the rank's
    stream ms of an earlier frame, taken once its events had passed (the
    pinned copy and query() path), and the busiest rank's collective ms
    reads them (their median)."""
    import statistics

    import torch.distributed as dist

    from rays1bench_tpu_torch.parallel import shard
    from rays1bench_tpu_torch.parallel.mesh import make_mesh
    from rays1bench_tpu_torch.utils import profiling

    cfg = RenderConfig(width=64, height=32, spp=4, max_bounces=8)
    s = builders.create_medium_scene(cfg.aspect, device=cuda)
    camera = s.camera.build(cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device=cuda)
        frame = lambda: shard.render_image_pallas_sharded(
            s.spheres, camera, cfg, mesh, n_real=s.n_real, respawn=True,
            telemetry=True)
        frame()
        with profiling.session():
            outs = []
            for _ in range(4):
                outs.append(frame())
                torch.cuda.synchronize()
        rows = [shard.rank_rows(t)[0] for _, t in profiling.counts("ranks")]
        assert [r["frame"] for r in rows] == [-1.0, 0.0, 1.0, 2.0]
        assert [r["iters"] for r in rows] == \
            [int(o[2]["device_iters"][0]) for o in outs]
        for r in rows[1:]:
            assert min(r["local_ms"], r["collective_ms"], r["issue_ms"]) > 0
        assert shard.busiest_collective_ms() == statistics.median(
            r["collective_ms"] for r in rows[1:])
    finally:
        dist.destroy_process_group()


# (width, height, spp) of the raygen kernel's cases; ids: "frame" (ray-id
# order), "band" (an 8-row band), "slice" (the last rank's padded slice of a
# 4-rank split, shuffled).
RAYGEN_CASES = {
    "the CLI frame": (1280, 720, 10, "frame"),
    "a band of the fit frame": (1280, 720, 32, "band"),
    "a padded slice, shuffled": (1281, 721, 10, "slice"),
    "an odd size": (161, 93, 3, "frame"),      # a partial last block
}


@pytest.mark.parametrize("case", RAYGEN_CASES)
def test_raygen_kernel_equals_plain_version(cuda, case):
    """megakernel.generate_rays launches the kernel of csrc/raygen.cu once,
    and its six planes equal primary_rays at the ids' pixel coordinates,
    on the card, bit for bit (a large seed, the large scene's lens)."""
    from rays1bench_tpu_torch.parallel.shard import ray_slice

    w, h, spp, ids = RAYGEN_CASES[case]
    cfg = RenderConfig(width=w, height=h, spp=spp, seed=2 ** 31 + 5)
    camera = builders.create_large_scene(cfg.aspect,
                                         device=cuda).camera.build(cuda)
    if ids == "band":
        ray_id = torch.arange(356 * w * spp, 364 * w * spp,
                              dtype=torch.int32, device=cuda)
    elif ids == "slice":
        ray_id = ray_slice(cfg, 4, 1, 3, 0, cuda)
        perm = torch.randperm(ray_id.numel(),
                              generator=torch.Generator().manual_seed(1))
        ray_id = ray_id[perm.to(cuda)].contiguous()
        assert int(ray_id.max()) >= cfg.num_primary_rays
    else:
        ray_id = torch.arange(cfg.num_primary_rays, dtype=torch.int32,
                              device=cuda)
    pixel = ray_id // spp
    want = primary_rays(camera, cfg, (pixel % w).float(),
                        (pixel // w).float(), ray_id)
    before = megakernel.RAYGEN_LAUNCHES
    got = megakernel.generate_rays(camera, cfg, ray_id)
    torch.cuda.synchronize()
    assert megakernel.RAYGEN_LAUNCHES == before + 1
    assert all(r.is_contiguous() for r in got)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def raygen_fit(device):
    """A small albedo fit's step on "mega", its target and config."""
    cfg = RenderConfig(width=48, height=32, spp=2, max_bounces=5,
                       early_exit=False)
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8,
                                        device=device)
    camera = scene.camera.build(device)
    with torch.no_grad():
        target = inverse.render_for_loss(scene.spheres, camera, cfg)
    params = inverse.params_of(scene.spheres, ("albedo_x",))
    step, _ = inverse.make_train_step(
        scene.spheres, camera, cfg,
        inverse.InverseConfig(learning_rate=1e-2, optimize=("albedo_x",)),
        params, engine="mega")
    return scene, camera, cfg, step, target


def test_raygen_launches_once_a_frame_or_step_and_is_recorded(cuda):
    """The raygen kernel launches once for a one-shot frame and once for a
    fit step, never for a respawn frame; under the profiler each records
    its "raygen" span and the counter raygen_kernel_rays, the frame's or
    step's primary rays."""
    from rays1bench_tpu_torch.utils import profiling

    scene, camera, cfg, step, target = raygen_fit(cuda)
    frame = lambda respawn: render_image_megakernel(
        scene.spheres, camera, cfg, scene.n_real, respawn=respawn)
    before = megakernel.RAYGEN_LAUNCHES
    frame(False)
    assert megakernel.RAYGEN_LAUNCHES == before + 1
    step(target)
    assert megakernel.RAYGEN_LAUNCHES == before + 2
    frame(True)
    assert megakernel.RAYGEN_LAUNCHES == before + 2
    with profiling.session():
        frame(False)
        step(target)
        frame(True)
        torch.cuda.synchronize()
    n = cfg.num_primary_rays
    assert profiling.counts("raygen_kernel_rays") == [(0, n), (1, n)]
    spans = profiling.spans("raygen")
    assert [s.frame for s in spans] == [0, 1]
    assert all(s.stream_ms > 0 for s in spans)


def test_camera_gradient_through_the_raygen_kernel(cuda, monkeypatch):
    """The camera's gradient on the fused path with the raygen kernel
    forward (its Function's backward replays the plain raygen) against
    autograd through primary_rays itself: within GRAD_TOL (kernel B sums
    its cotangents with float atomics), and not zero."""
    from rays1bench_tpu_torch.kernels import pipeline
    from rays1bench_tpu_torch.render.camera import build_camera
    from rays1bench_tpu_torch.render.pipeline import primary_rays_from_ids

    cfg = RenderConfig(width=64, height=32, spp=2, max_bounces=5, seed=9,
                       early_exit=False)
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8,
                                        device=cuda)
    spec = scene.camera
    weights = torch.rand((cfg.height, cfg.width, 3),
                         generator=torch.Generator().manual_seed(4)).to(cuda)

    def grads():
        lookfrom = torch.tensor(spec.lookfrom, dtype=torch.float32,
                                device=cuda, requires_grad=True)
        vfov = torch.tensor(spec.vfov, dtype=torch.float32, device=cuda,
                            requires_grad=True)
        camera = build_camera(lookfrom, spec.lookat, spec.vup, vfov,
                              spec.aspect, spec.aperture, spec.focus_dist)
        img, _ = render_image_mega(scene.spheres, camera, cfg)
        (img * weights).sum().backward()
        return lookfrom.grad, vfov.grad

    before = megakernel.RAYGEN_LAUNCHES
    kernel = grads()
    assert megakernel.RAYGEN_LAUNCHES == before + 1
    monkeypatch.setattr(pipeline, "generate_rays", primary_rays_from_ids)
    plain = grads()
    for a, b in zip(kernel, plain):
        assert float(b.abs().max()) > 0
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max())
