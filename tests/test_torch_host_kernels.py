"""Host rehearsal of the kernels' lanes: respawn, one-shot, phase, raygen,
fused backward and the index sweep's tile loop.

The per-lane bodies of kernels/csrc/respawn.cu, oneshot.cu, phase.cu,
raygen.cu, mega_backward.cu and intersect_index.cu live in header
functions, `r1b::respawn_pixel`, `r1b::oneshot_lane`, `r1b::phase_lane`,
`r1b::id_ray`, `r1b::index_tiles` (path_math.cuh) and `r1b::backward_ray`
(path_adjoint.cuh), that are plain C++ once `__device__` and
`__forceinline__` are defined away. This file compiles them with g++
-std=c++17 -O2 -ffp-contract=off (no contracted multiply-add, as nvcc
--fmad=false) into a scratch library, loops them over every pixel or ray
on the host, and holds them against the plain versions: the respawn,
one-shot and phase lanes bit for bit against trace_respawn_reference,
trace_topology_reference and wavefront_phase_reference, the raygen lane
bit for bit against render.pipeline.primary_rays, the index sweep
bit for bit against closest_hit_index_reference, the backward lane within
GRAD_TOL of backward_reference. The one-shot and phase lanes take their
rays (list entries) in an order that is not the input order (reversed, or
a seeded permutation), as a kernel's lanes refill from a counter, and must
still write every output at its ray's index (slot). The index sweep runs
one ray at a time through the block's tile loop (one thread stages each
tile). The warp-level parts of the kernels (ballots, shuffles,
__match_any_sync, the block's count reduction) stay in the .cu files;
here the row sums are plain adds in ray order, and the reverse loop runs
each ray's own depth.

Needs g++; skips without it.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.core.vecmath import f32
from rays1bench_tpu_torch.kernels import (build, intersect_index,
                                          mega_backward, megakernel)
from rays1bench_tpu_torch.kernels.pipeline import (frame_ray_ids,
                                                   prepare_trimmed)
from rays1bench_tpu_torch.parallel import shard
from rays1bench_tpu_torch.render.intersect import near_cut
from rays1bench_tpu_torch.render.pipeline import (primary_rays,
                                                  primary_rays_from_ids)
from rays1bench_tpu_torch.scene import builders
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS
from rays1bench_tpu_torch.scene.spheres import prepare

torch.set_num_threads(1)

# The fused backward's bar on the card (chip_smoke.py GRAD_TOL): max abs gap
# per column and ray plane over the column's max abs value. The host sums
# in another order than autograd and follows the hand adjoint's operation
# order.
GRAD_TOL = 1e-3

SHIM = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <vector>

#define __device__
#define __forceinline__ inline
struct float4 { float x, y, z, w; };
static inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
}

#include "path_math.cuh"
#include "path_adjoint.cuh"

extern "C" void respawn_frame(const float* sph, int S, const float* cam,
                              int width, int height, int spp, int s_lo,
                              int s_hi, int max_bounces, float t_min,
                              uint32_t seed, float inv_w, float inv_h,
                              float* rr, float* rg, float* rb, int* cnt) {
  std::vector<float4> hot(S);
  std::vector<float> pay(3 * (size_t)S);
  for (int s = 0; s < S; ++s) r1b::stage_row(sph, S, s, hot.data(), pay.data());
  for (int pid = 0; pid < width * height; ++pid) {
    float r = 0.0f, g = 0.0f, b = 0.0f;
    cnt[pid] = r1b::respawn_pixel(hot.data(), pay.data(), S, cam, pid,
                                  (float)(pid % width), (float)(pid / width),
                                  spp, s_lo, s_hi, max_bounces, t_min, seed,
                                  inv_w, inv_h, r, g, b);
    rr[pid] = r;
    rg[pid] = g;
    rb[pid] = b;
  }
}

template <bool kSoft, int kCap>
static void backward_all(const float* tab, int S, const float* const* ray,
                         const int* ray_id, const float* const* ct,
                         const int* topo, int N, int n_rays, int max_bounces,
                         float t_min, uint32_t seed, float inv_eps,
                         float* grads, float* const* g_ray) {
  for (int i = 0; i < N; ++i) {
    const float o[3] = {ray[0][i], ray[1][i], ray[2][i]};
    const float d[3] = {ray[3][i], ray[4][i], ray[5][i]};
    const float crad[3] = {ct[0][i], ct[1][i], ct[2][i]};
    float go[3], gd[3];
    r1b::backward_ray<kSoft, kCap>(
        tab, S, topo + i, N, ray_id[i] < n_rays, (uint32_t)ray_id[i], o, d,
        crad, max_bounces, t_min, seed, inv_eps, go, gd,
        [](int live) { return live; },
        [&](bool has, int j, const float* gcol) {
          if (has)
            for (int g = 0; g < r1b::kNumGrad; ++g) grads[g * S + j] += gcol[g];
        });
    for (int k = 0; k < 3; ++k) {
      g_ray[k][i] = go[k];
      g_ray[3 + k][i] = gd[k];
    }
  }
}

// One lane takes every ray, in `order`; or, with nest, each ray in that
// order is traced alone by oneshot_ray.
template <bool kSoft>
static unsigned long long oneshot_all(
    const float* sph, int S, const float* const* ray, const int* ray_id,
    int N, int n_rays, int max_bounces, float t_min, uint32_t seed,
    float inv_eps, float near_cut, int nest, const int* order, float* rr,
    float* rg, float* rb, int* cnt, int* topo) {
  std::vector<float4> hot(S);
  std::vector<float> pay(4 * (size_t)S);
  for (int s = 0; s < S; ++s) {
    r1b::stage_row(sph, S, s, hot.data(), pay.data());
    pay[3 * S + s] = sqrtf(r1b::clamp_min_nan(sph[r1b::kRSQ * S + s], 0.0f));
  }
  if (nest) {
    unsigned long long total = 0;
    for (int k = 0; k < N; ++k)
      total += r1b::oneshot_ray<kSoft>(
          hot.data(), pay.data(), S, order[k], ray[0], ray[1], ray[2], ray[3],
          ray[4], ray[5], ray_id, N, n_rays, max_bounces, t_min, seed,
          inv_eps, near_cut, rr, rg, rb, cnt, topo);
    return total;
  }
  int taken = 0;
  auto take = [&](bool need, int) {
    return need ? (taken < N ? order[taken++] : N) : 0;
  };
  auto any = [](bool p) { return p; };
  return r1b::oneshot_lane<kSoft>(
      hot.data(), pay.data(), S, ray[0], ray[1], ray[2], ray[3], ray[4],
      ray[5], ray_id, N, n_rays, max_bounces, t_min, seed, inv_eps,
      near_cut, rr, rg, rb, cnt, topo, take, any);
}

extern "C" unsigned long long oneshot_rays(
    const float* sph, int S, const float* const* ray, const int* ray_id,
    int N, int n_rays, int max_bounces, float t_min, uint32_t seed, int soft,
    float inv_eps, float near_cut, int nest, const int* order, float* rr,
    float* rg, float* rb, int* cnt, int* topo) {
  auto fn = soft ? oneshot_all<true> : oneshot_all<false>;
  return fn(sph, S, ray, ray_id, N, n_rays, max_bounces, t_min, seed, inv_eps,
            near_cut, nest, order, rr, rg, rb, cnt, topo);
}

// One lane takes every list entry of a phase, in `order`; or, with nest,
// the ray of each entry in that order is advanced alone by phase_ray.
extern "C" void phase_rays(const float* sph, int S, float* state,
                           uint8_t* alive, const int* ray_id, int* cnt,
                           const int* slots, int M, int N, int b0, int bend,
                           int max_bounces, float t_min, uint32_t seed,
                           int nest, const int* order) {
  std::vector<float4> hot(S);
  std::vector<float> pay(3 * (size_t)S);
  for (int s = 0; s < S; ++s)
    r1b::stage_row(sph, S, s, hot.data(), pay.data());
  if (nest) {
    for (int k = 0; k < M; ++k)
      r1b::phase_ray(hot.data(), pay.data(), S,
                     slots ? slots[order[k]] : order[k], state, alive,
                     ray_id, cnt, N, b0, bend, max_bounces, t_min, seed);
    return;
  }
  int taken = 0;
  auto take = [&](bool need, int) {
    return need ? (taken < M ? order[taken++] : M) : 0;
  };
  auto any = [](bool p) { return p; };
  r1b::phase_lane(hot.data(), pay.data(), S, state, alive, ray_id, cnt, slots,
                  M, N, b0, bend, max_bounces, t_min, seed, take, any);
}

extern "C" void raygen_rays(const int* ray_id, int N, const float* cam,
                            int width, int spp, uint32_t seed, float inv_w,
                            float inv_h, float* const* ray) {
  for (int i = 0; i < N; ++i)
    r1b::id_ray(cam, ray_id[i], width, spp, seed, inv_w, inv_h, ray[0][i],
                ray[1][i], ray[2][i], ray[3][i], ray[4][i], ray[5][i]);
}

extern "C" void index_rays(const float* const* col, int S,
                           const float* const* ray, int N, float t_min,
                           int* idx, uint8_t* hit) {
  std::vector<float4> tile(S < r1b::kIndexTile ? S : r1b::kIndexTile);
  for (int i = 0; i < N; ++i) {
    float bt;
    idx[i] = r1b::index_tiles(col[0], col[1], col[2], col[3], col[4], S, 0, 1,
                              tile.data(), t_min, ray[0][i], ray[1][i],
                              ray[2][i], ray[3][i], ray[4][i], ray[5][i], bt,
                              [] {});
    hit[i] = bt < 0x1.c363ccp+127f ? 1 : 0;
  }
}

// The depth caps of mega_backward.cu: the smallest that holds max_bounces.
extern "C" void backward_rays(const float* tab, int S, const float* const* ray,
                              const int* ray_id, const float* const* ct,
                              const int* topo, int N, int n_rays,
                              int max_bounces, float t_min, uint32_t seed,
                              int soft, float inv_eps, float* grads,
                              float* const* g_ray) {
  auto fn = soft ? (max_bounces <= 10 ? backward_all<true, 10>
                                      : backward_all<true, 50>)
                 : (max_bounces <= 10 ? backward_all<false, 10>
                                      : backward_all<false, 50>);
  fn(tab, S, ray, ray_id, ct, topo, N, n_rays, max_bounces, t_min, seed,
     inv_eps, grads, g_ray);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' lane functions")
    d = tmp_path_factory.mktemp("host_kernels")
    src, lib = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(SHIM)
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-Wno-unknown-pragmas", "-shared", "-fPIC",
                    f"-I{build.CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.respawn_frame.argtypes = [p, i, p, i, i, i, i, i, i, f,
                                  ctypes.c_uint32, f, f, p, p, p, p]
    lib.backward_rays.argtypes = [p, i, p, p, p, p, i, i, i, f,
                                  ctypes.c_uint32, i, f, p, p]
    lib.oneshot_rays.argtypes = [p, i, p, p, i, i, i, f, ctypes.c_uint32, i,
                                 f, f, i, p, p, p, p, p, p]
    lib.oneshot_rays.restype = ctypes.c_ulonglong
    lib.index_rays.argtypes = [p, i, p, i, f, p, p]
    lib.raygen_rays.argtypes = [p, i, p, i, i, ctypes.c_uint32, f, f, p]
    lib.phase_rays.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, f,
                               ctypes.c_uint32, i, p]
    return lib


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


@pytest.mark.parametrize("scene,w,h,spp,mb,span", [
    ("small", 64, 32, 4, 6, (0, 4)),    # hollow glass
    ("small", 64, 32, 4, 6, (1, 3)),
    ("small", 64, 32, 4, 6, (2, 2)),    # an empty span traces nothing
    ("large", 40, 24, 2, 10, (0, 2)),   # 512 rows
])
def test_respawn_lane_equals_plain_version(host_lib, scene, w, h, spp, mb,
                                           span):
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb)
    sc = builders.SCENES[scene](cfg.aspect, device="cpu")
    packed = megakernel.pack_spheres(prepare_trimmed(sc.spheres, sc.n_real))
    cam = megakernel.pack_camera(sc.camera.build("cpu"))
    want, want_cnt, _ = megakernel.trace_respawn(packed, cam, cfg, span)
    got = [torch.empty(cfg.num_pixels) for _ in range(3)]
    cnt = torch.empty(cfg.num_pixels, dtype=torch.int32)
    host_lib.respawn_frame(ptr(packed), packed.shape[1], ptr(cam), w, h, spp,
                           *span, mb, cfg.t_min, cfg.seed, 1.0 / w, 1.0 / h,
                           *map(ptr, got), ptr(cnt))
    assert torch.equal(cnt, want_cnt)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (int(cnt.sum()) == 0) == (span[0] == span[1])


@pytest.mark.parametrize("w,h,spp,seed,ids", [
    (64, 36, 10, 0, "frame"),
    (161, 93, 3, 2 ** 31 + 12345, "frame"),     # odd size, a large seed
    (40, 24, 4, 7, "padded slice, shuffled"),   # ids past the frame
])
def test_raygen_lane_equals_plain_version(host_lib, w, h, spp, seed, ids):
    """r1b::id_ray, the raygen kernel's lane, over ray ids in ray-id order
    or a rank's padded slice in a seeded shuffle: its six planes equal
    primary_rays at the ids' pixel coordinates bit for bit."""
    cfg = RenderConfig(width=w, height=h, spp=spp, seed=seed)
    camera = builders.create_large_scene(cfg.aspect,
                                         device="cpu").camera.build("cpu")
    if ids == "frame":
        ray_id = frame_ray_ids(cfg, "cpu")
    else:
        ray_id = shard.ray_slice(cfg, 7, 1, 6, 0, "cpu")
        ray_id = ray_id[torch.randperm(ray_id.numel(),
                                       generator=torch.Generator().
                                       manual_seed(3))].contiguous()
        assert int(ray_id.max()) >= cfg.num_primary_rays
    pixel = ray_id // spp
    want = primary_rays(camera, cfg, (pixel % w).float(),
                        (pixel // w).float(), ray_id)
    cam = megakernel.pack_camera(camera)
    got = [torch.empty(ray_id.numel()) for _ in range(6)]
    host_lib.raygen_rays(ptr(ray_id), ray_id.numel(), ptr(cam), w, spp, seed,
                         1.0 / w, 1.0 / h, ptrs(got))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def soa_grads(soa, grads):
    """GRAD_ROWS cotangents chained onto the scene's float columns."""
    floats = [c for c in COLUMNS if c != "mat_type"]
    soa = dataclasses.replace(soa, **{
        c: getattr(soa, c).detach().clone().requires_grad_(True)
        for c in floats})
    prep = prepare(soa)
    torch.autograd.backward(
        [getattr(prep, n) for n in mega_backward.GRAD_ROWS], list(grads))
    return [getattr(soa, c).grad for c in floats]


@pytest.mark.parametrize("soft", [0.0, 0.005])
def test_backward_lane_matches_backward_reference(host_lib, soft):
    cfg = RenderConfig(width=64, height=32, spp=2, max_bounces=4, seed=5,
                       early_exit=False, soft_silhouette=soft)
    scene = builders.SCENES["small"](cfg.aspect, pad_multiple=8, device="cpu")
    prep = prepare(scene.spheres)
    ray_id = frame_ray_ids(cfg, "cpu")
    rays = [r.contiguous() for r in primary_rays_from_ids(
        scene.camera.build("cpu"), cfg, ray_id)]
    _, _, _, topo = megakernel.trace_topology(megakernel.pack_spheres(prep),
                                              *rays, ray_id, cfg)
    n = ray_id.numel()
    cts = [torch.from_numpy(c) for c in
           (np.random.default_rng(7).random((3, n)) - 0.5).astype(np.float32)]
    table = mega_backward.pack_exact(prep).contiguous()
    grads = torch.zeros((mega_backward.NUM_GRAD, prep.count))
    ray_cts = [torch.empty(n) for _ in range(6)]
    host_lib.backward_rays(ptr(table), prep.count, ptrs(rays), ptr(ray_id),
                           ptrs(cts), ptr(topo.contiguous()), n,
                           cfg.num_primary_rays, cfg.max_bounces, cfg.t_min,
                           cfg.seed, int(soft > 0),
                           f32(1.0 / soft) if soft else 0.0, ptr(grads),
                           ptrs(ray_cts))
    ref, ref_cts = mega_backward.backward_reference(prep, *rays, ray_id, *cts,
                                                    topo, cfg)
    pairs = list(zip(ray_cts, ref_cts))
    if soft:
        # The raw inv_radius column is rounding noise in soft mode (the
        # normal is renormalized): compare the scene's own columns.
        noise = mega_backward.GRAD_ROWS.index("inv_radius")
        pairs += [(grads[k], ref[k]) for k in range(len(ref)) if k != noise]
        pairs += list(zip(soa_grads(scene.spheres, grads),
                          soa_grads(scene.spheres, ref)))
    else:
        pairs += list(zip(grads, ref))
    for a, b in pairs:
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max())
    assert float(grads[:, scene.n_real:].abs().max()) == 0.0


def ragged_with_padding(cfg, scene, cut, pad):
    """The frame's primary rays less the last `cut`, then `pad` padding rays
    (ids >= cfg.num_primary_rays, planes copied from the first rays)."""
    ray_id = frame_ray_ids(cfg, "cpu")
    rays = primary_rays_from_ids(scene.camera.build("cpu"), cfg, ray_id)
    keep = ray_id.numel() - cut
    rays = [torch.cat([r[:keep], r[:pad]]).contiguous() for r in rays]
    ids = torch.cat([ray_id[:keep], cfg.num_primary_rays + torch.arange(
        pad, dtype=torch.int32)]).contiguous()
    return rays, ids


@pytest.mark.parametrize("order", ["reversed", "permuted", "nest"])
@pytest.mark.parametrize("scene,w,h,spp,mb,soft", [
    ("small", 64, 32, 2, 5, 0.0),      # hollow glass, fuzzed metal
    ("medium", 32, 18, 2, 10, 0.0),    # 48 rows
    ("small", 64, 32, 2, 5, 0.005),    # soft: promotion, two-branch draw
])
def test_oneshot_lane_equals_plain_version(host_lib, scene, w, h, spp, mb,
                                           soft, order):
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb, seed=5,
                       early_exit=False, soft_silhouette=soft)
    sc = builders.SCENES[scene](cfg.aspect, pad_multiple=8, device="cpu")
    packed = megakernel.pack_spheres(prepare(sc.spheres))
    rays, ray_id = ragged_with_padding(cfg, sc, cut=5, pad=7)
    n = ray_id.numel()
    want_rad, want_cnt, want_topo = megakernel.trace_topology_reference(
        packed, *rays, ray_id, cfg)
    # The flat loop's lane refills in the given order; the nest (tables of
    # fewer than 16 rows) traces each ray alone, here in a seeded order.
    take = (np.arange(n)[::-1] if order == "reversed"
            else np.random.default_rng(3).permutation(n)).astype(np.int32)
    rad = [torch.full((n,), float("nan")) for _ in range(3)]
    cnt = torch.full((n,), -7, dtype=torch.int32)
    topo = torch.full((mb + 1, n), -7, dtype=torch.int32)
    total = host_lib.oneshot_rays(
        ptr(packed), packed.shape[1], ptrs(rays), ptr(ray_id), n,
        cfg.num_primary_rays, mb, cfg.t_min, cfg.seed, int(soft > 0),
        f32(1.0 / soft) if soft else 0.0, near_cut(soft) if soft else 0.0,
        int(order == "nest"), ptr(torch.from_numpy(np.ascontiguousarray(take))),
        *map(ptr, rad), ptr(cnt), ptr(topo))
    assert torch.equal(cnt, want_cnt)
    assert all(torch.equal(a, b) for a, b in zip(rad, want_rad))
    assert torch.equal(topo, want_topo)
    assert total == int(want_cnt.sum())
    assert int(cnt[-7:].abs().sum()) == 0 and bool((topo[:, -7:] == -1).all())
    assert int(((topo >= 0).sum(0) > 1).sum()) > 0  # rays of several bounces


@pytest.mark.parametrize("order", ["reversed", "permuted", "nest"])
@pytest.mark.parametrize("scene,w,h,spp,mb,schedules,ragged", [
    # chip_smoke.PHASE_CASES: hollow glass; the budget runs out first;
    # ragged with padding ids. The small scene's 8 rows take the per-ray
    # nest on the card, 48 rows the flat loop.
    ("small", 64, 32, 8, 6, [(2, 5), (2, 3, 6), (1,)], False),
    ("small", 64, 32, 8, 3, [(2, 3, 6)], False),
    ("small", 50, 30, 2, 4, [(2, 5), (2, 3, 6), (1,)], True),
    ("medium", 32, 18, 2, 10, [(2, 3, 6), (1,)], False),
])
def test_phase_lane_equals_plain_version(host_lib, scene, w, h, spp, mb,
                                         schedules, ragged, order):
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb)
    sc = builders.SCENES[scene](cfg.aspect, pad_multiple=8, device="cpu")
    prep = (prepare(sc.spheres) if scene == "medium"
            else prepare_trimmed(sc.spheres, sc.n_real))
    packed = megakernel.pack_spheres(prep)
    if ragged:
        rays, ray_id = ragged_with_padding(cfg, sc, cut=5, pad=7)
    else:
        ray_id = frame_ray_ids(cfg, "cpu")
        rays = [r.contiguous() for r in primary_rays_from_ids(
            sc.camera.build("cpu"), cfg, ray_id)]
    n = ray_id.numel()
    rng = np.random.default_rng(3)
    for schedule in schedules:
        state, alive, cnt = megakernel.wavefront_state(*rays, ray_id, cfg)
        spans = megakernel.wavefront_spans(schedule, mb)
        for k, (b0, bend) in enumerate(spans):
            slots = (alive.nonzero()[:, 0].to(torch.int32).contiguous() if k
                     else None)
            m = n if slots is None else slots.numel()
            ref = [t.clone() for t in (state, alive, cnt)]
            megakernel.wavefront_phase_reference(packed, ref[0], ref[1],
                                                 ray_id, ref[2], slots, b0,
                                                 bend, cfg)
            take = (np.arange(m)[::-1] if order == "reversed"
                    else rng.permutation(m)).astype(np.int32)
            host_lib.phase_rays(
                ptr(packed), packed.shape[1], ptr(state), ptr(alive),
                ptr(ray_id), ptr(cnt),
                None if slots is None else ptr(slots), m, n, b0, bend, mb,
                cfg.t_min, cfg.seed, int(order == "nest"),
                ptr(torch.from_numpy(np.ascontiguousarray(take))))
            assert torch.equal(state, ref[0]), (schedule, k)
            assert torch.equal(alive, ref[1]) and torch.equal(cnt, ref[2])
        want_rad, want_cnt, _ = megakernel.trace_topology_reference(
            packed, *rays, ray_id, cfg)
        assert torch.equal(cnt, want_cnt)
        assert all(torch.equal(a, b) for a, b in zip(state[9:], want_rad))
        if ragged:
            assert int(cnt[-7:].abs().sum()) == 0
    assert int(cnt.max()) > 2  # rays that outlive the first span


INDEX_TILE = 1024  # r1b::kIndexTile


def index_rays(seed, n, prep):
    """n seeded rays: origins in a box above the ground, half of them aimed
    near a random row's center, every 37th direction zero."""
    r = np.random.default_rng(seed)
    o = (r.random((3, n)) * 2 - 1) * 6.0
    o[1] = np.abs(o[1]) + 0.2
    d = r.standard_normal((3, n))
    c = torch.stack([prep.center_x, prep.center_y,
                     prep.center_z]).numpy()[:, r.integers(0, prep.count, n)]
    d[:, ::2] = (c + r.standard_normal((3, n)) * 0.3 - o)[:, ::2]
    d /= np.linalg.norm(d, axis=0)
    d[:, ::37] = 0.0
    return [torch.from_numpy(x.astype(np.float32)) for x in (*o, *d)]


@pytest.mark.parametrize("scene,rows", [
    ("small", None),     # 8 rows, less than a tile
    ("medium", None),    # 48
    ("giant", 1500),     # a tile and a ragged one
    ("giant", None),     # 4,096: four whole tiles
])
def test_index_tiles_equal_plain_version(host_lib, scene, rows):
    sc = builders.SCENES[scene](16 / 9, pad_multiple=8, device="cpu")
    prep = prepare(sc.spheres)
    if rows:
        prep = dataclasses.replace(prep, **{
            f.name: getattr(prep, f.name)[:rows].contiguous()
            for f in dataclasses.fields(prep)})
    rays = index_rays(11, 1000, prep)
    want_idx, want_hit = intersect_index.closest_hit_index_reference(
        intersect_index.pack(prep), *rays, 1e-3)
    cols = [getattr(prep, c).contiguous() for c in
            ("center_x", "center_y", "center_z", "radius_sq", "valid")]
    idx = torch.full((1000,), -7, dtype=torch.int32)
    hit = torch.full((1000,), 7, dtype=torch.uint8)
    host_lib.index_rays(ptrs(cols), prep.count, ptrs(rays), 1000, 1e-3,
                        ptr(idx), ptr(hit))
    assert torch.equal(idx, want_idx)
    assert torch.equal(hit.bool(), want_hit)
    assert 0 < int(want_hit.sum()) < 1000
    if prep.count > INDEX_TILE:  # winners in later tiles too
        assert int(want_idx.max()) >= INDEX_TILE


# A ray kept on the card by rays1bench_tpu_torch.bench.gradcase (NVIDIA H100
# 80GB HBM3): the small scene after 150 Adam steps of the soft geometry fit
# (rows 0-4 moved to these center_x, center_y and radius, float32 bits),
# and ray 1242821 of its 1280x720 @ 4 spp frame, which bounces between row
# 2 (metal, fuzz 0.3) and row 1 (the ground) for ten segments and leaves
# to the sky at the eleventh. Its radiance cotangents are random_cts' of
# seed 2.
TRAPPED_SCENE = {
    "center_x": ["-0x1.df002ap-13", "0x1.24de2ap-5", "0x1.01dc6cp+0",
                 "-0x1.0088b0p+0", "-0x1.00c8b4p+0"],
    "center_y": ["0x1.439adap-12", "-0x1.91ff6ep+6", "0x1.c0a286p-7",
                 "0x1.0e20eep-11", "-0x1.628f3cp-10"],
    "radius": ["0x1.fdca46p-2", "0x1.8ffe18p+6", "0x1.05a354p-1",
               "0x1.fd590ep-2", "-0x1.cdbfacp-2"],
}
TRAPPED_RAY = 1242821
TRAPPED_CTS = ("0x1.bbf5e4p-2", "-0x1.1ddd02p-2", "-0x1.bd0fa8p-4")
# The fuzz cotangent of row 2 summed over the whole frame's 3,686,400 rays
# by the plain version on the card (bench.gradcase --replay; the kernel
# gave 4.172177314758301, a gap of 4.6e-4 of the sum).
FRAME_FUZZ_ROW2 = 4.1702728271484375


def test_backward_lane_on_a_ray_trapped_between_two_spheres(host_lib):
    """Why a whole-frame check of the soft backward once missed GRAD_TOL
    relative to a column's max |sum|: one ray's term outweighs the sum. The
    trapped ray's fuzz cotangent of row 2 is more than 10 times the frame's
    sum of that entry. The backward lane (the kernel's per-ray math) and
    backward_reference, both float32, agree on every column of the ray to
    1e-4 of the column's own magnitude, and yet their gap on that entry is
    above 2e-4 of the frame's sum. The term itself is ill-conditioned: the
    same replay in float64 moves it by more than 2%. So chip_smoke.py holds
    whole-frame column sums to GRAD_TOL of their summed scale."""
    cfg = RenderConfig(width=1280, height=720, spp=4, max_bounces=10, seed=3,
                       early_exit=False, soft_silhouette=0.005)
    scene = builders.SCENES["small"](cfg.aspect, pad_multiple=8, device="cpu")
    cols = {}
    for c, hexes in TRAPPED_SCENE.items():
        col = getattr(scene.spheres, c).clone()
        col[:len(hexes)] = torch.tensor([float.fromhex(h) for h in hexes])
        cols[c] = col
    soa = dataclasses.replace(scene.spheres, **cols)
    ray_id = frame_ray_ids(cfg, "cpu")
    sl = slice(TRAPPED_RAY, TRAPPED_RAY + 1)
    ids = ray_id[sl].contiguous()
    rays = [r.contiguous() for r in primary_rays_from_ids(
        scene.camera.build("cpu"), cfg, ids)]
    cts = [torch.tensor([float.fromhex(h)]) for h in TRAPPED_CTS]
    prep = prepare(soa)
    _, cnt, topo = megakernel.trace_topology_reference(
        megakernel.pack_spheres(prep), *rays, ids, cfg)
    assert topo[:, 0].tolist() == [2, 1] * 5 + [-1]
    ref, _ = mega_backward.backward_reference(prep, *rays, ids, *cts, topo,
                                              cfg)
    table = mega_backward.pack_exact(prep).contiguous()
    grads = torch.zeros((mega_backward.NUM_GRAD, prep.count))
    ray_cts = [torch.empty(1) for _ in range(6)]
    host_lib.backward_rays(ptr(table), prep.count, ptrs(rays), ptr(ids),
                           ptrs(cts),
                           ptr(topo.contiguous()), 1, cfg.num_primary_rays,
                           cfg.max_bounces, cfg.t_min, cfg.seed, 1,
                           f32(1.0 / cfg.soft_silhouette), ptr(grads),
                           ptrs(ray_cts))
    noise = mega_backward.GRAD_ROWS.index("inv_radius")
    for k in range(mega_backward.NUM_GRAD):
        if k != noise and float(ref[k].abs().max()) > 0.0:
            assert float((grads[k] - ref[k]).abs().max()) <= \
                1e-4 * float(ref[k].abs().max())
    fuzz = mega_backward.GRAD_ROWS.index("fuzz")
    term, gap = float(ref[fuzz, 2]), float((grads - ref)[fuzz, 2])
    assert abs(term) > 10 * abs(FRAME_FUZZ_ROW2)
    assert abs(gap) > 2e-4 * abs(FRAME_FUZZ_ROW2)
    exact = {f.name: getattr(prep, f.name).double()
             if getattr(prep, f.name).is_floating_point()
             else getattr(prep, f.name) for f in dataclasses.fields(prep)}
    ref64, _ = mega_backward.backward_reference(
        dataclasses.replace(prep, **exact), *(r.double() for r in rays), ids,
        *(c.double() for c in cts), topo, cfg)
    assert abs(float(ref64[fuzz, 2]) - term) > 2e-2 * abs(term)


def test_variants_patch_text_the_kernels_hold():
    """bench.variants builds each variant by replacing lines of the tree's
    (or a parent's) kernel sources: every replacement of a tree variant
    must find its text in kernels/csrc, or the variant would not build."""
    from rays1bench_tpu_torch.bench import variants
    for kernel, entries in variants.VARIANTS.items():
        for name, src, subs in entries:
            for fname, old, _ in subs if src == "tree" else ():
                text = (build.CSRC / fname).read_text()
                assert old in text, (kernel, name, fname)
