"""The redesigned respawn kernel and fused backward against their
alternatives, on one CUDA card, in one process.

    git archive <parent> rays1bench_tpu_torch/kernels/csrc | \\
        tar -x -C tmp/parent_csrc --strip-components=3
    python -m rays1bench_tpu_torch.bench.variants --parent tmp/parent_csrc

Each variant is a copy of kernels/csrc (or of the parent's sources, given
by --parent) with a few lines replaced (VARIANTS), built into a temporary
directory with the flags of kernels/build.py and loaded in place of the
kernel's library; the wrapper then runs it as it runs the kernel. The
variants answer the design questions of the two kernels:

  respawn, at the headline (large 1280x720 @ 250 spp @ 50 b): the parent;
  the flat loop (the tree's kernel); the same sweep in a loop nest
  (samples, then bounces); the flat loop with a branch around the respawn,
  which nvcc turns back into a nest; unroll 4 and 16 instead of 8; 16x2
  and 4x8 pixels a warp instead of 8x4.

  backward, on the soft geometry fit's frame, the medium stage-2 soft frame
  and the medium and large 1280x720 @ 4 @ 10 frames: the parent and the
  parent without its accumulation (what its shared atomics cost); the
  tree's kernel and it without its accumulation; with a reduce-scatter
  butterfly for warps whose lanes all hold one row; with a static
  grid-stride share of the rays per block instead of the chunk counter.

Each kernel is timed in turns, every variant once in order and once in
reverse order (the parent first and last): respawn frames between CUDA
events, two a turn; backward launches alone as bench.grad.launch_ms times
them, five a turn. Every variant's frame must equal the tree kernel's bit
for bit; every backward variant's ray cotangents must equal the parent's
and its columns come within GRAD_TOL of them, except where the
accumulation is removed. Prints one line per kernel and variant with the
card's name and power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import tempfile

import torch

from rays1bench_tpu_torch.bench.grad import (GEOMETRY, cuda_ms, launch_ms,
                                             moved_geometry)
from rays1bench_tpu_torch.bench.profile import smi
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import build, mega_backward, megakernel
from rays1bench_tpu_torch.kernels.pipeline import prepare_trimmed, ray_coords
from rays1bench_tpu_torch.render.pipeline import primary_rays
from rays1bench_tpu_torch.scene import builders
from rays1bench_tpu_torch.scene.spheres import prepare

GRAD_TOL = 1e-3   # chip_smoke.GRAD_TOL
HEADLINE = RenderConfig(width=1280, height=720, spp=250, max_bounces=50)
FIT = dict(width=1280, height=720, spp=4, max_bounces=10, early_exit=False)

TILE = "constexpr int kWarpW = 8, kWarpH = 4;"
UNROLL = "constexpr int kSweepUnroll = 8;"
CALL = "cnt = r1b::respawn_pixel("
NESTED = r"""namespace {

__device__ __forceinline__ int respawn_nested(
    const float4* hot, const float* pay, int S, const float* cam, int pid,
    float xf, float yf, int spp, int s_lo, int s_hi, int max_bounces,
    float t_min, uint32_t seed, float inv_w, float inv_h, float& rr,
    float& rg, float& rb) {
  int cnt = 0;
  for (int s = s_lo; s < s_hi; ++s) {
    float ox, oy, oz, dx, dy, dz;
    const uint32_t rid = r1b::pixel_ray(cam, pid, s, spp, xf, yf, seed,
                                        inv_w, inv_h, ox, oy, oz, dx, dy, dz);
    float ar = 1.0f, ag = 1.0f, ab = 1.0f;
    for (int b = 0;; ++b) {
      ++cnt;
      float bt;
      const int best = r1b::sweep4(hot, S, t_min, ox, oy, oz, dx, dy, dz, bt);
      if (!(bt < 0x1.c363ccp+127f)) {
        float skr, skg, skb;
        r1b::sky_color(dy, skr, skg, skb);
        rr = rr + ar * skr;
        rg = rg + ag * skg;
        rb = rb + ab * skb;
        break;
      }
      const r1b::Hit h = r1b::unpack_hit4(hot, pay, S, best, bt, ox, oy, oz,
                                          dx, dy, dz);
      float sx, sy, sz;
      const bool ok = r1b::scatter(h, dx, dy, dz, seed, rid, (uint32_t)b, sx,
                                   sy, sz);
      if (!(ok && b < max_bounces)) break;
      ox = h.px; oy = h.py; oz = h.pz;
      dx = sx; dy = sy; dz = sz;
      ar = ar * h.albedo_x; ag = ag * h.albedo_y; ab = ab * h.albedo_z;
    }
  }
  return cnt;
}
"""
# The flat loop's body with a branch around the respawn.
SELECTS = r"""    const bool hit = bt < 0x1.c363ccp+127f;
    float skr, skg, skb;
    sky_color(dy, skr, skg, skb);
    rr = hit ? rr : rr + ar * skr;
    rg = hit ? rg : rg + ag * skg;
    rb = hit ? rb : rb + ab * skb;
    const Hit h = unpack_hit4(hot, pay, S, hit ? best : 0, bt, ox, oy, oz,
                              dx, dy, dz);
    float sx, sy, sz;
    const bool ok = scatter(h, dx, dy, dz, seed, rid, (uint32_t)b, sx, sy,
                            sz);
    const bool cont = hit && ok && b < max_bounces;
    s += cont ? 0 : 1;
    if (s >= s_hi) break;
    float nox, noy, noz, ndx, ndy, ndz;
    const uint32_t nrid = pixel_ray(cam, pid, s, spp, xf, yf, seed, inv_w,
                                    inv_h, nox, noy, noz, ndx, ndy, ndz);
    ox = cont ? h.px : nox;
    oy = cont ? h.py : noy;
    oz = cont ? h.pz : noz;
    dx = cont ? sx : ndx;
    dy = cont ? sy : ndy;
    dz = cont ? sz : ndz;
    ar = cont ? ar * h.albedo_x : 1.0f;
    ag = cont ? ag * h.albedo_y : 1.0f;
    ab = cont ? ab * h.albedo_z : 1.0f;
    rid = cont ? rid : nrid;
    b = cont ? b + 1 : 0;"""
BRANCH = r"""    bool cont = false;
    if (!(bt < 0x1.c363ccp+127f)) {
      float skr, skg, skb;
      sky_color(dy, skr, skg, skb);
      rr = rr + ar * skr;
      rg = rg + ag * skg;
      rb = rb + ab * skb;
    } else {
      const Hit h = unpack_hit4(hot, pay, S, best, bt, ox, oy, oz, dx, dy,
                                dz);
      float sx, sy, sz;
      const bool ok = scatter(h, dx, dy, dz, seed, rid, (uint32_t)b, sx, sy,
                              sz);
      cont = ok && b < max_bounces;
      if (cont) {
        ox = h.px; oy = h.py; oz = h.pz;
        dx = sx; dy = sy; dz = sz;
        ar = ar * h.albedo_x; ag = ag * h.albedo_y; ab = ab * h.albedo_z;
        ++b;
      }
    }
    if (!cont) {
      if (++s >= s_hi) break;
      rid = pixel_ray(cam, pid, s, spp, xf, yf, seed, inv_w, inv_h, ox, oy,
                      oz, dx, dy, dz);
      ar = ag = ab = 1.0f;
      b = 0;
    }"""

PARENT_ACC = """        for (int g = 0; g < r1b::kNumGrad; ++g)
          atomicAdd(&acc[g * S + j], gcol[g]);"""
ACC = "warp_add(acc, S, lane, has, j, gcol);"
# Keeps the column cotangents live, adds nothing.
NOACC = ("float z = 0.0f; for (int g = 0; g < r1b::kNumGrad; ++g) "
         "z += gcol[g]; if (has && z == 1.2345e-37f) acc[0] = z;")
PARENT_NOACC = """        for (int g = 0; g < r1b::kNumGrad; ++g)
          go[0] += 0.0f * gcol[g];"""
TREE = "  if (!has) return;\n"
REDUCE_SCATTER = r"""  const int j0 = __shfl_sync(kFull, j, __ffs(m | 1u) - 1);
  if (m != 0 && __all_sync(kFull, !has || j == j0)) {
    float v[16];
#pragma unroll
    for (int g = 0; g < 16; ++g)
      v[g] = g < r1b::kNumGrad && has ? gcol[g] : 0.0f;
    {
      const bool up = (lane & 16) != 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float send = up ? v[k] : v[8 + k];
        const float keep = up ? v[8 + k] : v[k];
        v[k] = keep + __shfl_xor_sync(kFull, send, 16);
      }
    }
    {
      const bool up = (lane & 8) != 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float send = up ? v[k] : v[4 + k];
        const float keep = up ? v[4 + k] : v[k];
        v[k] = keep + __shfl_xor_sync(kFull, send, 8);
      }
    }
    {
      const bool up = (lane & 4) != 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float send = up ? v[k] : v[2 + k];
        const float keep = up ? v[2 + k] : v[k];
        v[k] = keep + __shfl_xor_sync(kFull, send, 4);
      }
    }
    {
      const bool up = (lane & 2) != 0;
#pragma unroll
      for (int k = 0; k < 1; ++k) {
        const float send = up ? v[k] : v[1 + k];
        const float keep = up ? v[1 + k] : v[k];
        v[k] = keep + __shfl_xor_sync(kFull, send, 2);
      }
    }
    v[0] += __shfl_xor_sync(kFull, v[0], 1);
    const int g = lane >> 1;
    if ((lane & 1) == 0 && g < r1b::kNumGrad) atomicAdd(&acc[g * S + j0], v[0]);
    return;
  }
  if (!has) return;
"""
DYNAMIC = """  for (;;) {
    int chunk = 0;
    if (lane == 0) chunk = atomicAdd(work, 1);
    const int base = __shfl_sync(kFull, chunk, 0) * 32;
    if (base >= N) break;
    const int i = base + lane;"""
STATIC = """  for (int base = blockIdx.x * kThreads; base < N;
       base += gridDim.x * kThreads) {
    const int i = base + tid;"""

# (name, "parent" or "tree" sources, [(file, old, new)]), the reference
# first: the tree's kernel for respawn, the parent for backward.
VARIANTS = {
    "respawn": [
        ("flat", "tree", []),
        ("parent", "parent", []),
        ("nested", "tree", [("respawn.cu", "namespace {\n", NESTED),
                            ("respawn.cu", CALL, "cnt = respawn_nested(")]),
        ("flat_branch", "tree", [("path_math.cuh", SELECTS, BRANCH)]),
        ("unroll4", "tree", [("path_math.cuh", UNROLL,
                              "constexpr int kSweepUnroll = 4;")]),
        ("unroll16", "tree", [("path_math.cuh", UNROLL,
                               "constexpr int kSweepUnroll = 16;")]),
        ("warp16x2", "tree", [("respawn.cu", TILE,
                               "constexpr int kWarpW = 16, kWarpH = 2;")]),
        ("warp4x8", "tree", [("respawn.cu", TILE,
                              "constexpr int kWarpW = 4, kWarpH = 8;")]),
    ],
    "mega_backward": [
        ("parent", "parent", []),
        ("parent_noacc", "parent", [("mega_backward.cu", PARENT_ACC,
                                     PARENT_NOACC)]),
        ("tree", "tree", []),
        ("tree_noacc", "tree", [("mega_backward.cu", ACC, NOACC)]),
        ("reduce_scatter", "tree", [("mega_backward.cu", TREE,
                                     REDUCE_SCATTER)]),
        ("static_share", "tree", [("mega_backward.cu", DYNAMIC, STATIC)]),
    ],
}
SOURCES = {"respawn": "respawn.cu", "mega_backward": "mega_backward.cu"}


def compile_variant(kernel, name, src_dir, subs, out_dir):
    """Build one variant's library; returns (name, path, ptxas lines)."""
    d = os.path.join(out_dir, f"{kernel}-{name}")
    shutil.copytree(src_dir, d)
    for fname, old, new in subs:
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise ValueError(f"{kernel} {name}: {fname} lacks the text to "
                             f"replace")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    lib = os.path.join(d, "lib.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
                           os.path.join(d, SOURCES[kernel])],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{kernel} {name}: nvcc failed\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    return name, lib, [ln.split(":", 1)[-1].strip() for ln in log
                       if "registers" in ln or "stack frame" in ln]


def loader(like, path, parent_backward):
    """A ctypes function of the library at path with like's signature; the
    parent's backward takes no chunk counter, so its adapter drops it."""
    fn = getattr(ctypes.CDLL(path), like.__name__)
    fn.restype = ctypes.c_int
    if parent_backward:
        fn.argtypes = like.argtypes[:-2] + like.argtypes[-1:]
        return lambda *a: fn(*a[:-2], a[-1])
    fn.argtypes = like.argtypes
    return fn


def turns(names):
    return names + names[::-1]


def respawn(fns):
    cfg = HEADLINE
    scene = builders.SCENES["large"](cfg.aspect, device="cuda")
    packed = megakernel.pack_spheres(prepare_trimmed(scene.spheres,
                                                     scene.n_real))
    cam = megakernel.pack_camera(scene.camera.build("cuda"))
    ms, ref = {n: [] for n in fns}, None
    for name in turns(list(fns)):
        megakernel._respawn_kernel = lambda fn=fns[name]: fn
        out = megakernel.trace_respawn(packed, cam, cfg)
        ref = ref or out
        if not (torch.equal(out[1], ref[1]) and
                all(torch.equal(a, b) for a, b in zip(out[0], ref[0]))):
            raise AssertionError(f"respawn {name}: the frame differs")
        ms[name].append(cuda_ms(lambda: megakernel.trace_respawn(
            packed, cam, cfg), reps=2)[1])
    for name, t in ms.items():
        print(f"[variants] respawn {name}: headline frame "
              f"{', '.join(f'{x:.3f}' for x in t)} ms, "
              f"{int(ref[2]) / min(t) / 1e3:.1f} mrays/s", flush=True)


def backward_case(label, scene_name, pad, cfg, move, fns):
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=pad,
                                        device="cuda")
    spheres = (moved_geometry(scene.spheres, scene_name) if move
               else scene.spheres)
    camera = scene.camera.build("cuda")
    prep = prepare(spheres)
    ray_id, x, y = ray_coords(cfg, "cuda")
    rays = [r.contiguous() for r in primary_rays(camera, cfg, x, y, ray_id)]
    _, _, total, topo = megakernel.trace_topology(
        megakernel.pack_spheres(prep), *rays, ray_id, cfg)
    ct = torch.full_like(rays[0], 1.0 / cfg.num_primary_rays)
    ms, outs = {n: [] for n in fns}, {}
    for name in turns(list(fns)):
        mega_backward._backward_kernel = lambda fn=fns[name]: fn
        run = lambda: mega_backward.backward(prep, *rays, ray_id, ct, ct, ct,
                                             topo, cfg)
        outs[name] = run()
        ms[name].append(launch_ms(run, reps=5)[1])
    want = outs["parent"]
    for name, (grads, ray_cts) in outs.items():
        if not all(torch.equal(a, b) for a, b in zip(ray_cts, want[1])):
            raise AssertionError(f"backward {name}: ray cotangents differ")
        rel = float((grads - want[0]).abs().max() / want[0].abs().max())
        if "noacc" not in name and not rel <= GRAD_TOL:
            raise AssertionError(f"backward {name}: columns differ by {rel}")
    for name, t in ms.items():
        print(f"[variants] backward {label}, {int(total)} live bounces, "
              f"{prep.count} rows, {name}: "
              f"{', '.join(f'{x:.4f}' for x in t)} ms", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a directory holding the parent's kernels/csrc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench.variants needs a CUDA device")
    print(f"[variants] card {smi('name', 'power.limit')[0]}", flush=True)
    out_dir = tempfile.mkdtemp(prefix="rays1bench_variants_")
    dirs = {"tree": str(build.CSRC), "parent": os.path.abspath(args.parent)}
    jobs = [(k, n, dirs[src], subs, out_dir)
            for k, vs in VARIANTS.items() for n, src, subs in vs]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda j: compile_variant(*j), jobs))
    libs = {}
    for (kernel, _, _, _, _), (name, path, regs) in zip(jobs, built):
        print(f"[variants] ptxas {kernel} {name}: {'; '.join(regs)}",
              flush=True)
        libs.setdefault(kernel, {})[name] = path
    like = megakernel._respawn_kernel()
    respawn({n: loader(like, p, False) for n, p in libs["respawn"].items()})
    like = mega_backward._backward_kernel()
    fns = {n: loader(like, p, n.startswith("parent"))
           for n, p in libs["mega_backward"].items()}
    small, medium = GEOMETRY["small"][0], GEOMETRY["medium"][0]
    backward_case("soft fit frame (small, 1280x720 @ 4 @ 10, soft 0.005)",
                  "small", 8, RenderConfig(**FIT, seed=small,
                                        soft_silhouette=0.005), True, fns)
    backward_case("medium stage-2 soft frame (1280x720 @ 4 @ 10, soft "
                  "0.005)", "medium", 8, RenderConfig(
                      **FIT, seed=medium, soft_silhouette=0.005), True, fns)
    backward_case("medium (1280x720 @ 4 @ 10)", "medium", 8,
                  RenderConfig(**FIT, seed=5), False, fns)
    backward_case("large (512 rows, 1280x720 @ 4 @ 10)", "large", 128,
                  RenderConfig(**FIT, seed=5), False, fns)
    shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
