"""Host rehearsal of the respawn kernel's and the fused backward's lanes.

The per-lane bodies of kernels/csrc/respawn.cu and mega_backward.cu live
in header functions, `r1b::respawn_pixel` (path_math.cuh) and
`r1b::backward_ray` (path_adjoint.cuh), that are plain C++ once
`__device__` and `__forceinline__` are defined away. This file compiles
them with g++ -std=c++17 -O2 -ffp-contract=off (no contracted
multiply-add, as nvcc --fmad=false) into a scratch library, loops them over
every pixel or ray on the host, and holds them against the plain versions:
the respawn lane bit for bit against trace_respawn_reference, the backward
lane within GRAD_TOL of backward_reference. The warp-level parts of the
kernels (shuffles, __match_any_sync, the block's count reduction) stay in
the .cu files; here the row sums are plain adds in ray order, and the
reverse loop runs each ray's own depth.

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
from rays1bench_tpu_torch.kernels import build, mega_backward, megakernel
from rays1bench_tpu_torch.kernels.pipeline import prepare_trimmed, ray_coords
from rays1bench_tpu_torch.render.pipeline import primary_rays
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
    ray_id, x, y = ray_coords(cfg, "cpu")
    rays = [r.contiguous() for r in primary_rays(scene.camera.build("cpu"),
                                                 cfg, x, y, ray_id)]
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
