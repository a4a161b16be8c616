"""The redesigned kernels against their alternatives, on one CUDA card, in
one process.

    git archive <parent> rays1bench_tpu_torch/kernels/csrc | \\
        tar -x -C tmp/parent_csrc --strip-components=3
    python -m rays1bench_tpu_torch.bench.variants --parent tmp/parent_csrc \\
        [--kernels oneshot,intersect_index]

--kernels picks the kernels whose variants run. The default is the
one-shot and index kernels, whose variants take the csrc of their
redesign's parent, 5a43459, as --parent. The respawn and backward variants
were written against the csrc of their own redesign's parent, 3290e84,
and the phase kernel's (--kernels phase) against d3f2684's.

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

  oneshot, on the CLI frame (large 1280x720 @ 10 spp @ 50 b, no topology),
  the medium and large 1280x720 @ 4 @ 10 topology frames (kernel A of the
  "mega" fit) and the soft fit's and the medium stage-2 soft frames: the
  tree's kernel (the flat loop that refills its lanes from the counter,
  one atomic a warp and round, writing its rays' topology tails); the
  parent (a loop nest, thread = ray); the parent with the float4 sweep of
  the tree's kernel; a warp claiming 32 or 128 rays an atomic; a static
  share of 32-ray chunks a warp (warp_stride) or of rays a lane
  (static_stride) instead of the counter; each lane one ray of its own
  and no refill (one_ray: the flat body as a nest); at least 10 or 12 resident
  blocks an SM (__launch_bounds__, fewer registers); the flat loop with the
  topology pre-filled with -1 by the launch instead of the tails. The
  tree's kIters instantiation (debug_iters) then gives each frame's warp
  trips, whose ratio to 32 times the rays traced is the tree's lane
  occupancy. Then the medium albedo recipe's and the small
  soft geometry recipe's whole "mega" training step with the tree's and
  the parent's one-shot library in turns, in one process (step_case).

  phase, on the CLI frame's wavefront (large 1280x720 @ 10 spp @ 50 b,
  schedule (2, 3, 6)), each phase from the same pre-phase state, which the
  tree's kernel leaves through the wavefront engine's own loop: the parent
  (a thread per listed ray and a block per 128 entries, each staging the
  row-major table); the tree's kernel (the flat loop that refills its lanes
  from the list counter, resident blocks, float4 hot rows); the tree's
  per-ray nest (phase_ray, float4 sweep) for every table, over resident
  blocks in a grid-stride loop (nest_float4) or a block per 128 entries
  (nest_float4_blocks); a static share of list entries a lane instead of
  the counter (static_stride); half the resident blocks (grid_half); the
  flat loop for every table, 8 rows too (flat_all); the tree's kernel with
  each phase's list in a seeded order (shuffled_lists);
  and `rounds`, the tree's kernel adding 32 times its warps' loop rounds to
  a second counter word, whose ratio to the bounces traced is the flat
  loop's lane occupancy in each phase. Then the small scene's frame (8
  rows: the tree takes the per-ray nest).

  intersect_index, on one chunk of the medium pipeline fit (131,072 primary
  rays x 48 rows) and the giant frame (1280x720 @ 4 spp x 4,096 rows): the
  parent (its call packs the table in torch, 128 threads a block, the
  whole table in shared memory), the tree's kernel (tiles of 1,024 rows,
  512 threads), the tree's float4 sweep without tiles at 128 threads, and
  tiles at 256 threads; each timed as a whole call and as the kernel's
  profiler device time alone.

Each kernel is timed in turns, every variant once in order and once in
reverse order (the parent first and last): respawn frames between CUDA
events, two a turn; backward, one-shot and index calls alone as
bench.grad.launch_ms times them, five a turn (one-shot: three); phases
alone, their buffers restored before each, three a turn. Every variant's
frame must equal the tree kernel's bit for bit (one-shot: radiance,
counts, topology and total; index: idx and hit; phase: state, alive flags
and counts after every phase);
every backward variant's ray cotangents must equal the parent's and its
columns come within GRAD_TOL of them, except where the accumulation is
removed. Prints one line per kernel and variant with the card's name and
power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from rays1bench_tpu_torch.bench.grad import (ALBEDOS, GEOMETRY, WAIT_CYCLES,
                                             cuda_ms, geometry_config,
                                             is_kernel, launch_ms,
                                             moved_geometry, perturb_albedos)
from rays1bench_tpu_torch.bench.profile import smi
from rays1bench_tpu_torch.core.config import RenderConfig, get_config
from rays1bench_tpu_torch.grad.inverse import (InverseConfig,
                                               make_train_step, params_of,
                                               render_for_loss)
from rays1bench_tpu_torch.kernels import (build, intersect_index,
                                          mega_backward, megakernel)
from rays1bench_tpu_torch.kernels.pipeline import (frame_ray_ids,
                                                   prepare_trimmed)
from rays1bench_tpu_torch.render.pipeline import primary_rays_from_ids
from rays1bench_tpu_torch.scene import builders
from rays1bench_tpu_torch.scene.spheres import prepare

GRAD_TOL = 1e-3   # chip_smoke.GRAD_TOL
HEADLINE = RenderConfig(width=1280, height=720, spp=250, max_bounces=50)
WAVEFRONT = (2, 3, 6)   # chip_smoke.WAVEFRONT
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

# The tree's refill: one atomic a round, of the lanes that need a ray.
TAKE = """    auto take = [&](bool need, int) {
      const unsigned m = __ballot_sync(kFull, need);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(work, __popc(m));
      base = __shfl_sync(kFull, base, 0);
      return base + __popc(m & ((1u << lane) - 1u));
    };"""
# Each lane a static share: rays gtid, gtid + T, gtid + 2T, ...
STRIDE = """    const int first = blockIdx.x * kThreads + tid;
    const int stride = gridDim.x * kThreads;
    auto take = [&](bool, int i) { return i < 0 ? first : i + stride; };"""


def pool_take(claim, static=False):
    """A warp claims `claim` consecutive rays at a time into a pool that its
    lanes take from by rank: from the counter, or with static=True from a
    static share of claim-ray chunks a warp (w, w + W, w + 2W, ...)."""
    fresh = ("""        fresh = next;
        next += stride;""" if static else """        if (lane == 0) fresh = atomicAdd(work, kClaim);
        fresh = __shfl_sync(kFull, fresh, 0);""")
    start = ("""
    int next = (blockIdx.x * kThreads + tid) / 32 * kClaim;
    const int stride = gridDim.x * (kThreads / 32) * kClaim;""" if static
             else "")
    return f"""    const int kClaim = {claim};
    int pool = 0, pool_end = 0;{start}
    auto take = [&](bool need, int) {{
      const unsigned m = __ballot_sync(kFull, need);
      const int c = __popc(m), rank = __popc(m & ((1u << lane) - 1u));
      const int left = pool_end - pool;
      const bool claim = c > left;
      int fresh = pool_end;
      if (claim) {{
{fresh}
      }}
      const int i = rank < left ? pool + rank : fresh + (rank - left);
      pool = claim ? fresh + (c - left) : pool + c;
      pool_end = claim ? fresh + kClaim : pool_end;
      return i;
    }};"""


# Each lane one ray, its own, and a block a ray's 128: the flat body as a
# loop nest (the warp runs as long as its deepest ray).
ONE_RAY = """    auto take = [&](bool, int i) {
      return i < 0 ? (int)(blockIdx.x * kThreads + tid) : N;
    };"""
GRID = ("  const int grid =\n      S < r1b::kNestRows || blocks < resident "
        "? blocks : resident;")
BOUNDS = "__global__ void __launch_bounds__(kThreads)\noneshot_kernel("
# The phase kernel's warp vote at its flat loop's head.
ANY = "    auto any = [](bool p) { return __any_sync(kFull, p) != 0; };"
TAILS = """      if (topo)
        for (int k = b + 1; k <= max_bounces; ++k)
          topo[(size_t)k * N + i] = -1;
"""
LAUNCH = "  if (err != cudaSuccess) return (int)err;\n  const int blocks"
PREFILL = """  if (err == cudaSuccess && topo)
    err = cudaMemsetAsync(topo, 0xFF,
                          sizeof(int) * (size_t)(max_bounces + 1) * N,
                          (cudaStream_t)stream);
""" + LAUNCH
# The parent's one-shot kernel with the tree's float4 sweep: the hot rows
# staged after its row-major table (and soft row), swept by sweep4.
PARENT_STAGE = ("  for (int i = tid; i < r1b::kNumRows * S; i += kThreads) "
                "sph[i] = spheres[i];")
STAGE4 = PARENT_STAGE + """
  float4* hot = reinterpret_cast<float4*>(sph + 8 * S);
  for (int s = tid; s < S; s += kThreads)
    hot[s] = float4{spheres[s], spheres[S + s], spheres[2 * S + s],
                    spheres[3 * S + s]};"""
PARENT_SMEM = "sizeof(float) * (r1b::kNumRows + (soft ? 1 : 0)) * (size_t)S;"

def unindent(text):
    """text two spaces to the left: the one-shot kernel's take and any lie
    inside a branch, the phase kernel's not."""
    return "\n".join(line[2:] for line in text.splitlines())


PHASE_NEST = """  if (S < r1b::kNestRows) {
    const int i = blockIdx.x * kThreads + tid;
    if (i < M)
      r1b::phase_ray(hot, pay, S, slots ? slots[i] : i, state, alive_io,
                     ray_id, cnt_io, N, b0, bend, max_bounces, t_min, seed);
    return;
  }"""
# Every table through the per-ray nest, a grid-stride loop of the resident
# blocks over the list.
PHASE_NEST_STRIDE = """  for (int i = blockIdx.x * kThreads + tid; i < M;
       i += gridDim.x * kThreads)
    r1b::phase_ray(hot, pay, S, slots ? slots[i] : i, state, alive_io,
                   ray_id, cnt_io, N, b0, bend, max_bounces, t_min, seed);
  return;"""
PHASE_CALL = """  r1b::phase_lane(hot, pay, S, state, alive_io, ray_id, cnt_io, slots, M, N,
                  b0, bend, max_bounces, t_min, seed, take, any);"""
PHASE_ROUNDS = """  int rounds = 0;
  auto any = [&](bool p) {
    const bool r = __any_sync(kFull, p) != 0;
    rounds += r ? 1 : 0;
    return r;
  };"""
INDEX_TILE = "constexpr int kIndexTile = 1024;"
INDEX_THREADS = "constexpr int kThreads = 512;"

# (name, "parent" or "tree" sources, [(file, old, new)]), the reference
# first: the tree's kernel for respawn, one-shot and index, the parent for
# backward.
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
    "oneshot": [
        ("flat", "tree", []),
        ("parent", "parent", []),
        ("nest_float4", "parent", [
            ("oneshot.cu", PARENT_STAGE, STAGE4),
            ("oneshot.cu", "r1b::sweep(sph, S, t_min,",
             "r1b::sweep4(hot, S, t_min,"),
            ("oneshot.cu", PARENT_SMEM,
             "sizeof(float) * (r1b::kNumRows + 1 + 4) * (size_t)S;")]),
        ("claim32", "tree", [("oneshot.cu", TAKE, pool_take(32))]),
        ("claim128", "tree", [("oneshot.cu", TAKE, pool_take(128))]),
        ("warp_stride", "tree", [("oneshot.cu", TAKE,
                                  pool_take(32, static=True))]),
        ("static_stride", "tree", [("oneshot.cu", TAKE, STRIDE)]),
        ("one_ray", "tree", [("oneshot.cu", TAKE, ONE_RAY),
                             ("oneshot.cu", GRID,
                              "  const int grid = blocks;")]),
        ("min_blocks10", "tree", [("oneshot.cu", BOUNDS, BOUNDS.replace(
            "(kThreads)", "(kThreads, 10)"))]),
        ("min_blocks12", "tree", [("oneshot.cu", BOUNDS, BOUNDS.replace(
            "(kThreads)", "(kThreads, 12)"))]),
        ("prefill", "tree", [("path_math.cuh", TAILS, ""),
                             ("oneshot.cu", LAUNCH, PREFILL)]),
    ],
    "phase": [
        ("parent", "parent", []),
        ("flat", "tree", []),
        ("nest_float4", "tree", [("phase.cu", PHASE_NEST,
                                  PHASE_NEST_STRIDE)]),
        ("nest_float4_blocks", "tree", [
            ("phase.cu", "  if (S < r1b::kNestRows) {", "  if (S >= 0) {"),
            ("phase.cu", GRID, "  const int grid = blocks;")]),
        ("static_stride", "tree", [("phase.cu", unindent(TAKE),
                                    unindent(STRIDE))]),
        ("grid_half", "tree", [("phase.cu", GRID, GRID.replace(
            ": resident;", ": resident / 2;"))]),
        ("flat_all", "tree", [
            ("phase.cu", "  if (S < r1b::kNestRows) {", "  if (S < 0) {"),
            ("phase.cu", GRID, GRID.replace("S < r1b::kNestRows || ", ""))]),
        ("rounds", "tree", [
            ("phase.cu", unindent(ANY), PHASE_ROUNDS),
            ("phase.cu", PHASE_CALL, PHASE_CALL + "\n  if (lane == 0) "
             "atomicAdd(work + 1, 32 * rounds);")]),
    ],
    "intersect_index": [
        ("tiles512", "tree", []),
        ("parent", "parent", []),
        ("whole128", "tree", [
            ("path_math.cuh", INDEX_TILE, "constexpr int kIndexTile = 4096;"),
            ("intersect_index.cu", INDEX_THREADS,
             "constexpr int kThreads = 128;")]),
        ("tiles256", "tree", [("intersect_index.cu", INDEX_THREADS,
                               "constexpr int kThreads = 256;")]),
    ],
}
SOURCES = {"respawn": "respawn.cu", "mega_backward": "mega_backward.cu",
           "oneshot": "oneshot.cu", "intersect_index": "intersect_index.cu",
           "phase": "phase.cu"}


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


def loader(like, path, drop=0):
    """A ctypes function of the library at path with like's signature, less
    the `drop` arguments before the stream that a parent's launch lacks:
    the backward and phase parents take no counter (1); the one-shot
    parent no counter and no trip total (2), the respawn parent no first
    row, no trip total and no block stride (3)."""
    fn = getattr(ctypes.CDLL(path), like.__name__)
    fn.restype = ctypes.c_int
    if drop:
        fn.argtypes = like.argtypes[:-1 - drop] + like.argtypes[-1:]
        return lambda *a: fn(*a[:-1 - drop], a[-1])
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
    ray_id = frame_ray_ids(cfg, "cuda")
    rays = [r.contiguous() for r in primary_rays_from_ids(camera, cfg, ray_id)]
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


def oneshot_case(label, scene_name, pad, cfg, move, topology, fns):
    """One frame through every one-shot variant in turns; every variant's
    radiance, counts, topology and total must equal the tree kernel's. The
    tree's lane occupancy from its kIters instantiation's trips."""
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=pad or 128,
                                        device="cuda")
    spheres = (moved_geometry(scene.spheres, scene_name) if move
               else scene.spheres)
    # pad None: the render engines' sort-trimmed table.
    prep = (prepare_trimmed(spheres, scene.n_real) if pad is None
            else prepare(spheres))
    packed = megakernel.pack_spheres(prep)
    ray_id = frame_ray_ids(cfg, "cuda")
    rays = [r.contiguous() for r in primary_rays_from_ids(
        scene.camera.build("cuda"), cfg, ray_id)]
    trace = megakernel.trace_topology if topology else megakernel.trace_oneshot
    run = lambda: trace(packed, *rays, ray_id, cfg)
    ms, outs = {n: [] for n in fns}, {}
    for name in turns(list(fns)):
        megakernel._oneshot_kernel = lambda fn=fns[name]: fn
        outs[name] = run()
        ms[name].append(launch_ms(run)[1])
    want = outs["flat"]
    for name, out in outs.items():
        same = (all(torch.equal(a, b) for a, b in zip(out[0], want[0]))
                and torch.equal(out[1], want[1])
                and (not topology or torch.equal(out[3], want[3]))
                and int(out[2]) == int(want[2]))
        if not same:
            raise AssertionError(f"oneshot {name}: {label} differs")
    rays_traced = int(want[2])
    megakernel._oneshot_kernel = lambda: fns["flat"]
    trips = int(megakernel._oneshot(packed, *rays, ray_id, cfg, topology,
                                    True)[4])
    occupancy = (f", lane occupancy {rays_traced / (32 * trips):.4f} "
                 f"({trips} warp trips)")
    for name, t in ms.items():
        print(f"[variants] oneshot {label}, {prep.count} rows, {rays_traced} "
              f"rays traced, {name}: {', '.join(f'{x:.4f}' for x in t)} ms"
              + (occupancy if name == "flat" else ""), flush=True)


def step_case(label, scene_name, cfg, fns, rounds=5, steps=20):
    """grad.inverse.make_train_step's "mega" step with each one-shot
    variant's library in turns, `rounds` times: ms a step over `steps`
    steps between CUDA events. In one process, so that the host's noise
    from process to process stays out of the comparison."""
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=8,
                                        device="cuda")
    camera = scene.camera.build("cuda")
    with torch.no_grad():
        target = render_for_loss(scene.spheres, camera, cfg, engine="mega")
    if cfg.soft_silhouette:
        start, inv = (moved_geometry(scene.spheres, scene_name),
                      geometry_config(scene_name))
    else:
        start = perturb_albedos(scene.spheres, scene.n_real)
        inv = InverseConfig(learning_rate=1e-2, optimize=ALBEDOS)
    ms = {n: [] for n in fns}
    for _ in range(rounds):
        for name in turns(list(fns)):
            megakernel._oneshot_kernel = lambda fn=fns[name]: fn
            step, _ = make_train_step(start, camera, cfg, inv,
                                      params_of(start, inv.optimize),
                                      engine="mega")
            step(target)
            step(target)
            ms[name].append(cuda_ms(lambda: [
                step(target) for _ in range(steps)])[1] / steps)
    for name, t in ms.items():
        print(f"[variants] oneshot step, {label}, {name}: median "
              f"{float(np.median(t)):.4f} ms a step "
              f"({', '.join(f'{x:.3f}' for x in t)})", flush=True)


def phase_launch(fn, packed, bufs, ray_id, slots, b0, bend, cfg, work):
    """One phase through the library fn on bufs = (state, alive, cnt), in
    place, with the list counter (and rounds' word) in work."""
    state, alive, cnt = bufs
    m = ray_id.numel() if slots is None else slots.numel()
    err = fn(packed.data_ptr(), packed.shape[1], state.data_ptr(),
             alive.data_ptr(), ray_id.data_ptr(), cnt.data_ptr(),
             None if slots is None else slots.data_ptr(), m, ray_id.numel(),
             b0, bend, cfg.max_bounces, cfg.t_min, cfg.seed, work.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"phase kernel launch failed: cudaError {err}")


def phase_case(label, scene_name, fns, reps=3):
    """A CLI frame's wavefront phases through every phase variant in turns,
    each phase from the pre-phase state that the tree's kernel left through
    megakernel._wavefront, and through the tree's kernel with each list in a
    seeded order (shuffled_lists); every variant's state, alive flags and
    counts must equal the tree kernel's after every phase. Each library is
    called once before the turns (its module loads at its first launch).
    Prints ms per phase and their sum for each variant, and rounds' lane
    occupancy per phase."""
    cfg = get_config("full")
    scene = builders.SCENES[scene_name](cfg.aspect, device="cuda")
    packed = megakernel.pack_spheres(prepare_trimmed(scene.spheres,
                                                     scene.n_real))
    ray_id = frame_ray_ids(cfg, "cuda")
    rays = [r.contiguous() for r in primary_rays_from_ids(
        scene.camera.build("cuda"), cfg, ray_id)]
    pre, post = [], []

    def keep(packed, state, alive, ray_id, cnt, slots, b0, bend, cfg):
        pre.append(([t.clone() for t in (state, alive, cnt)], slots, b0,
                    bend))
        megakernel.wavefront_phase(packed, state, alive, ray_id, cnt, slots,
                                   b0, bend, cfg)
        post.append([t.clone() for t in (state, alive, cnt)])

    megakernel._wavefront(keep, packed, *rays, ray_id, cfg, WAVEFRONT)
    bufs = [t.clone() for t in pre[0][0]]
    work = torch.zeros(2, dtype=torch.int32, device="cuda")
    gen = torch.Generator("cuda").manual_seed(12)
    shuffled = []
    for _, slots, _, _ in pre:
        todo = (torch.arange(ray_id.numel(), dtype=torch.int32,
                             device="cuda") if slots is None else slots)
        shuffled.append(todo[torch.randperm(todo.numel(), device="cuda",
                                            generator=gen)].contiguous())
    fns = dict(fns, shuffled_lists=fns["flat"])
    for name, fn in fns.items():
        for b, s in zip(bufs, pre[0][0]):
            b.copy_(s)
        work.zero_()
        phase_launch(fn, packed, bufs, ray_id, pre[0][1], *pre[0][2:], cfg,
                     work)
    torch.cuda.synchronize()
    ms = {n: [[] for _ in pre] for n in fns}
    rounds = [0] * len(pre)
    for name in turns(list(fns)):
        for k, (start, slots, b0, bend) in enumerate(pre):
            if name == "shuffled_lists":
                slots = shuffled[k]
            for _ in range(reps):
                for b, s in zip(bufs, start):
                    b.copy_(s)
                work.zero_()
                torch.cuda.synchronize()
                begin = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(WAIT_CYCLES)
                begin.record()
                phase_launch(fns[name], packed, bufs, ray_id, slots, b0, bend,
                             cfg, work)
                end.record()
                end.synchronize()
                ms[name][k].append(begin.elapsed_time(end))
            if not all(torch.equal(a, b) for a, b in zip(bufs, post[k])):
                raise AssertionError(f"phase {name}: phase {k} differs from "
                                     f"the tree kernel's")
            if name == "rounds":
                rounds[k] = int(work[1])
    spans = [(b0, bend) for _, _, b0, bend in pre]
    listed = [ray_id.numel() if s is None else s.numel() for _, s, _, _ in pre]
    bounces = [int((p[2] - s[0][2]).sum(dtype=torch.int64))
               for p, s in zip(post, pre)]
    print(f"[variants] phase {label} (1280x720 @ 10 @ 50, "
          f"{packed.shape[1]} rows), spans {spans}, rays listed {listed}, "
          f"bounces traced {bounces}", flush=True)
    for name, per in ms.items():
        medians = [float(np.median(t)) for t in per]
        occ = (", lane occupancy " + ", ".join(
            f"{b / r:.4f}" for b, r in zip(bounces, rounds))
            if name == "rounds" and all(rounds) else "")
        print(f"[variants] phase {label}, {name}: "
              + "; ".join(f"[{b0}, {bend}) {', '.join(f'{x:.3f}' for x in t)}"
                          for (b0, bend), t in zip(spans, per))
              + f" ms; sum of medians {sum(medians):.3f} ms" + occ,
              flush=True)


def index_call(fn, parent, prep, rays, t_min):
    """closest_hit_index through the library fn: the tree's kernel reads the
    prepared columns; the parent's takes the (4, S) table that its wrapper
    packed in torch on every call."""
    n = rays[0].numel()
    idx = torch.empty(n, dtype=torch.int32, device="cuda")
    hit = torch.empty(n, dtype=torch.bool, device="cuda")
    table = [intersect_index.pack(prep)] if parent else [
        getattr(prep, c) for c in intersect_index._COLUMNS]
    err = fn(*(t.data_ptr() for t in table), prep.count,
             *(r.data_ptr() for r in rays), n, t_min, idx.data_ptr(),
             hit.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"index kernel launch failed: cudaError {err}")
    return idx, hit


def kernel_alone_ms(run, reps):
    """Profiler device ms of index_kernel a call, over reps calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    return sum((e.time_range.end - e.time_range.start) / 1e3
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and is_kernel(e.name, "index_kernel")) / reps


def index_case(label, scene_name, n, fns):
    cfg = RenderConfig(**FIT, seed=5)
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=8,
                                        device="cuda")
    prep = prepare(scene.spheres)
    ray_id = frame_ray_ids(cfg, "cuda")
    rays = [r[:n].contiguous() for r in primary_rays_from_ids(
        scene.camera.build("cuda"), cfg, ray_id)]
    ms, alone, outs = {k: [] for k in fns}, {k: [] for k in fns}, {}
    reps = 5 if n < 1 << 20 else 2
    for name in turns(list(fns)):
        run = lambda fn=fns[name], p=name == "parent": index_call(
            fn, p, prep, rays, cfg.t_min)
        outs[name] = run()
        ms[name].append(launch_ms(run, reps=reps)[1])
        alone[name].append(kernel_alone_ms(run, 20 if reps == 5 else 2))
    want = outs["tiles512"]
    for name, out in outs.items():
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            raise AssertionError(f"index {name}: {label} differs")
    for name in fns:
        print(f"[variants] index {label}, {prep.count} rows, {n} rays, "
              f"{name}: call {', '.join(f'{x:.4f}' for x in ms[name])} ms; "
              f"kernel alone {', '.join(f'{x:.4f}' for x in alone[name])} "
              f"ms", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a directory holding the parent's kernels/csrc")
    ap.add_argument("--kernels", default="oneshot,intersect_index",
                    help="comma-separated kernels whose variants to run")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("bench.variants needs a CUDA device")
    print(f"[variants] card {smi('name', 'power.limit')[0]}", flush=True)
    out_dir = tempfile.mkdtemp(prefix="rays1bench_variants_")
    dirs = {"tree": str(build.CSRC), "parent": os.path.abspath(args.parent)}
    jobs = [(k, n, dirs[src], subs, out_dir)
            for k, vs in VARIANTS.items() if k in kernels
            for n, src, subs in vs]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda j: compile_variant(*j), jobs))
    libs = {}
    for (kernel, _, _, _, _), (name, path, regs) in zip(jobs, built):
        print(f"[variants] ptxas {kernel} {name}: {'; '.join(regs)}",
              flush=True)
        libs.setdefault(kernel, {})[name] = path
    small, medium = GEOMETRY["small"][0], GEOMETRY["medium"][0]
    soft_small = RenderConfig(**FIT, seed=small, soft_silhouette=0.005)
    soft_medium = RenderConfig(**FIT, seed=medium, soft_silhouette=0.005)
    if "respawn" in libs:
        like = megakernel._respawn_kernel()
        respawn({n: loader(like, p, 3 if n == "parent" else 0)
                 for n, p in libs["respawn"].items()})
    if "mega_backward" in libs:
        like = mega_backward._backward_kernel()
        fns = {n: loader(like, p, 1 if n.startswith("parent") else 0)
               for n, p in libs["mega_backward"].items()}
        backward_case("soft fit frame (small, 1280x720 @ 4 @ 10, soft "
                      "0.005)", "small", 8, soft_small, True, fns)
        backward_case("medium stage-2 soft frame (1280x720 @ 4 @ 10, soft "
                      "0.005)", "medium", 8, soft_medium, True, fns)
        backward_case("medium (1280x720 @ 4 @ 10)", "medium", 8,
                      RenderConfig(**FIT, seed=5), False, fns)
        backward_case("large (512 rows, 1280x720 @ 4 @ 10)", "large", 128,
                      RenderConfig(**FIT, seed=5), False, fns)
    if "oneshot" in libs:
        like = megakernel._oneshot_kernel()
        fns = {n: loader(like, p, 2 if n in ("parent", "nest_float4") else 0)
               for n, p in libs["oneshot"].items()}
        oneshot_case("CLI frame (large 1280x720 @ 10 @ 50)", "large", None,
                     get_config("full"), False, False, fns)
        oneshot_case("CLI frame (small 1280x720 @ 10 @ 50)", "small", None,
                     get_config("full"), False, False, fns)
        oneshot_case("medium A (1280x720 @ 4 @ 10)", "medium", 8,
                     RenderConfig(**FIT, seed=5), False, True, fns)
        oneshot_case("large A (1280x720 @ 4 @ 10)", "large", 128,
                     RenderConfig(**FIT, seed=5), False, True, fns)
        oneshot_case("soft A (small, 1280x720 @ 4 @ 10, soft 0.005)",
                     "small", 8, soft_small, True, True, fns)
        oneshot_case("soft medium A (1280x720 @ 4 @ 10, soft 0.005)",
                     "medium", 8, soft_medium, True, True, fns)
        pair = {n: fns[n] for n in ("flat", "parent")}
        step_case("medium albedo recipe (1280x720 @ 4 @ 10)", "medium",
                  RenderConfig(**FIT, seed=5), pair)
        step_case("small soft geometry recipe (1280x720 @ 4 @ 10, soft "
                  "0.005)", "small", soft_small, pair)
    if "phase" in libs:
        like = megakernel._phase_kernel()
        fns = {n: loader(like, p, 1 if n == "parent" else 0)
               for n, p in libs["phase"].items()}
        phase_case("CLI wavefront frame, large", "large", fns)
        phase_case("CLI wavefront frame, small (the per-ray nest)", "small",
                   fns)
    if "intersect_index" in libs:
        like = intersect_index._index_kernel()
        fns = {}
        for n, p in libs["intersect_index"].items():
            fn = getattr(ctypes.CDLL(p), like.__name__)
            fn.restype = ctypes.c_int
            fn.argtypes = (like.argtypes[4:] if n == "parent"
                           else like.argtypes)
            fns[n] = fn
        index_case("medium chunk", "medium", 131_072, fns)
        index_case("giant frame (1280x720 @ 4 spp)", "giant", 3_686_400, fns)
    shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
