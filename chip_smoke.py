#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rays1bench_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Requires a CUDA device and prints the card's name and power limit.
2. Builds the five kernels from kernels/csrc with nvcc (sm_90a), one nvcc
   each, all started together, and prints the build time and ptxas's
   register and spill report.
3. Holds the respawn kernel against its plain PyTorch version on the card,
   on the same inputs: per-pixel ray counts and the 64-bit total must be
   equal and per-pixel sample sums within SUM_TOL. A two-span split of the samples is
   held against the full span. The kIters instantiation (debug_iters) gives
   the same outputs and warp trips equal to respawn_iters_reference of the
   per-pixel counts.
4. Drives the main path, render_image_megakernel through the benchmark
   harness, at the headline: large scene, 1280x720 @ 250 spp @ 50 bounces,
   one warm frame and two timed frames. The ray count must be within 0.3% of
   the reference binary's 631,145,620 and the image must pass the golden
   block-mean check (16x16 blocks, mean 1.25 / max 3.5 per channel, u8).
5. Checks that the main path launched the kernel.
6. Holds the kernel against its plain version at the headline itself: one
   more launch at the headline's shape (its image must equal the main
   path's), and the plain version on the card for a few hundred of its
   pixels (a whole 16x8 block, the last column, the top row, the corners
   and pixels spread over the frame): counts equal, sums within SUM_TOL.
   Then the lane occupancy of the respawn kernel's schedule (occupancy):
   on a 160x90 crop of the headline, a loop nest that starts a warp's next
   sample only when its 16x2 pixels all ended theirs (the plain version,
   one sample at a time), against the flat loop's 8x4-pixel warps, which
   run as long as their busiest pixel, on the crop and on the headline
   launch's own per-pixel counts. Then the kIters instantiation at the
   headline, in turns with the kernel without it (its cost), its trips
   equal to the plain twin of the frame's counts.
7. The gradient kernels against their plain versions on the card, on the
   small scene at 64x32 @ 2 spp @ 3 and 5 b (hollow glass, fuzzed metal,
   dielectric) and the medium and large scenes at 160x90 @ 4 spp @ 10 b:
   the topology kernel's topology, counts and radiance equal bit for bit;
   the fused backward's column and ray cotangents within GRAD_TOL of
   backward_reference, placeholder rows exactly 0, all finite.
8. Drives the gradient path: grad.inverse.fit_scene on the medium scene at
   1280x720 @ 4 spp @ 10 b (seed 5, 48 rows), all albedos perturbed by
   RandomState(11) factors, fitted to the unperturbed render for 5 Adam
   steps at lr 1e-2. Both gradient kernels must launch at least 5 times,
   the loss must stay finite and fall. Then one step on the large scene
   (512 rows) at the same workload.
9. Holds the gradient kernels against their plain versions at that width,
   on the fitted medium scene and on the fitted large one (512 rows): the
   whole frame through the plain versions in chunks of rays (per-ray math
   does not depend on the other rays; the backward's column sums are held
   to GRAD_TOL of their summed scale, the sum over the plain version's
   chunks of |chunk sum|, see gradient_gap), and ~4k of its rays (a pixel
   block, the last column, the top row, the corners and seeded picks) as
   their own ray list, whose topology and ray cotangents must equal the
   whole-frame launch's bit for bit; and the whole frame's rays in a
   seeded order (REFILL_SEED), whose topology, counts and radiance must be
   the frame launch's, ray for ray. A gradient check that fails (here and in 7, 16
   and 18) first saves its inputs under tmp/grad_cases
   (bench.gradcase.save_case) and prints where.
10. The closest-hit index kernel against its plain version, idx and hit
   equal bit for bit: on the medium and giant frames' primary rays at
   1280x720 @ 4 spp (the plain version in chunks), on the giant frame cut
   to its first 1,500 rows (a whole 1,024-row tile of the kernel's shared
   memory and a ragged one), and on seeded random rays (N = 777 and
   100,000, zero directions among them). On one medium chunk and on each
   frame, the kernel's profiler device time alone beside the whole call's
   CUDA-event time; the call must run no other device work.
11. The phase kernel against its plain version on small 64x32 @ 8 spp @ 6 b
   (hollow glass) and 50x30 @ 2 spp @ 4 b (ragged), schedules (2, 5),
   (2, 3, 6) at 3 b (the budget runs out first) and (1,): after every phase
   the state, alive flags and counts equal bit for bit, and the whole
   trace's radiance and counts equal trace_wavefront_reference's.
12. Drives the one-shot and wavefront engines, render_image_megakernel(
   respawn=False) with and without wavefront=(2, 3, 6), at the CLI's full
   config on the large scene, 1280x720 @ 10 spp @ 50 b: the wavefront's
   image and ray count equal the one-shot's bit for bit; the one-shot's ray
   count equals the respawn engine's and its image is within SPLIT_TOL.
   Then both kernels against their plain versions on those frames' own
   inputs (9,216,000 rays), the plain versions in chunks of rays: the
   one-shot kernel's per-ray radiance and counts equal trace_topology_
   reference's bit for bit; each phase, from the same pre-phase state,
   leaves state, alive flags and counts equal to wavefront_phase_
   reference's over the same listed rays. Both comparison runs must
   reproduce the engines' frames. From the one-shot launch's per-ray
   counts, the lane occupancy a thread-per-ray loop nest would have on
   warps of 32 consecutive rays, beside the flat loop's time; then the
   frame's rays in a seeded order, each ray's outputs equal to the in-order
   launch's. Each phase's listed rays and ms, and the wavefront frame's
   time less its phases beside the one-shot frame's less its kernel: the
   difference is the listings' cost. Then the wavefront frame's phases
   with each list in a seeded order (REFILL_SEED), each ray's radiance and
   count equal to the in-order run's. The one-shot kIters instantiation on
   the CLI frame: outputs equal to the plain version's, warp trips no fewer
   than oneshot_iters_reference's fewest and 32 x trips >= the segments
   traced (the lane occupancy printed), and its cost in turns with the
   kernel without it.
13. Drives the multi-scene CLI at its defaults (small, medium, large, one
   run each, the one-shot engine) and parses each out_<scene>.txt.
14. engine="pipeline" gradients with the index kernel and with the plain
   sweep, medium 160x90 @ 4 spp @ 10 b: image, rays and gradients equal bit
   for bit.
15. Drives engine="pipeline": fit_scene on the medium recipe of step 8 for 3
   Adam steps, the target rendered through the pipeline; the loss stays
   finite and falls and the index kernel launches exactly chunks x 11 x 3
   times (once a bounce of each chunk of each forward, never in a
   backward). Peak device memory of one step with and without remat. Then
   one step on the giant scene (4,096 rows) through engine="auto", which
   must route to the pipeline. In both fits the index kernel's inputs and
   results on the first chunk (131,072 rays) of the first forward are kept
   for every bounce, 0 to 10, and held against its plain version, bit for
   bit: after bounce 0 the rays start on sphere surfaces, near t_min.
16. The soft-silhouette mode of both gradient kernels (soft_silhouette
   0.005) against their plain versions on the card: small 64x32 @ 2 spp @
   4 b (hollow glass) and 50x30 (ragged), medium 160x90 @ 4 spp @ 10 b
   (48 rows). The topology kernel's topology, counts and radiance equal bit
   for bit, with promoted lanes and pass-through draws > 0; the fused
   backward within GRAD_TOL of backward_reference on every column but the
   raw inv_radius one (rounding noise in soft mode: the normal is
   renormalized, so its exact derivative is 0), on the ray planes, and on
   the scene's own columns chained through scene/spheres.prepare.
17. Drives the soft path: the full-resolution geometry fit
   (tools/fullres_fit_probe.py:55-75), fit_scene(engine="mega") on the
   small scene at 1280x720 @ 4 spp @ 10 b, seed 3, row 0 moved by center_x
   +0.06, center_y -0.04, radius -0.03, 150 Adam steps at lr 2e-3 on
   center_x, center_y and radius, the target the unmoved scene's soft
   render. Each step renders twice (the U-statistic loss), so each kernel
   must launch 300 times; each of the three errors of row 0 must end below
   30% of its start (tools/fullres_fit_probe.py:116).
18. Both soft kernels against their plain versions on that fit's whole
   frame, 3,686,400 rays (the plain versions in chunks of rays), as in 16,
   and on ~4k of its rays launched as their own list, as in 9.
19. Soft step timings through bench.grad.run (--soft): the small
   full-resolution recipe and the medium stage-2 recipe
   (tools/medium_fit_probe.py:64-102), phases and kernels alone.
20. The sharded path (parallel/), [shard]. Its local functions
   (parallel/shard.kernel_local), every coordinate of a 4-way tile mesh and
   of a 2x2 (tiles, samples) mesh in turn on the one card, at the CLI's
   full config on the large scene: one-shot and wavefront images equal to
   step 12's frames bit for bit, respawn equal on the tile mesh and within
   SPLIT_TOL on 2x2 (each pixel's two sample spans added once), the ranks'
   rays summing to the frame's, respawn trips equal to the plain twin of
   each rank's per-pixel counts, one-shot trips inside their bounds. The
   sharded fused gradient on the medium fit frame, 4 ranks: kernel A on
   each rank's slice equal to the single-device launch bit for bit, kernel
   B's ray cotangents equal and its (10, S) columns summed over the ranks
   within GRAD_TOL of the single-device B (summed scales, as in 9). Then
   the path itself through a group of one NCCL rank: render_image_pallas_
   sharded for each engine (telemetry on the one-shot and respawn engines)
   and on a 1x1 mesh, equal to step 12's frames; the headline through
   respawn=True, equal to step 4's frame; one fit_scene(mesh=...) step on
   step 8's recipe through "mega" and "pipeline", each loss within
   GRAD_TOL of the unsharded step's.
21. The camera fit, [camfit]: grad.inverse.fit_camera on "mega", small scene
   at 1280x720 @ 4 spp @ 10 b, seed 3, the JAX recipe (tests/test_grad.py:
   514-549): lookfrom moved by (+0.06, -0.05, +0.04), lr 5e-3, and vfov
   +2 degrees, lr 5e-2, toward the true camera's render. Hard, the
   fixed-topology gradient has no silhouette terms and at this size points
   away from the true camera (ROADMAP.md §3, open fault 1): at each moved
   start the leaves' gradient through kernel B within GRAD_TOL of the
   replay path's (render_image_mega(fused=False)), printed beside central
   differences of the loss; kernels A and B against their plain versions
   on the moved lookfrom's frame (as in 9); twelve camera steps, both
   kernels launched once each, and the warm step's ms. With
   soft_silhouette SOFT the recipe's two 120-step fits must meet the JAX
   bars (last loss under 5% / 20% of the first, error under 0.015 / 0.6
   degrees), both kernels launching every step; the camera gradient at
   the fitted lookfrom within GRAD_TOL of the replay's; the warm step.
22. The tooling, [tooling]: bench.cli --scenes small --profile --report
   --save once, its Chrome trace holding the one-shot kernel's CUDA events
   and its report table the record it wrote; the native runtime built, its
   TGA equal to scene/tga.write_rgb24's bytes and its tonemap to the
   card's to_srgb_u8; device_memory_stats' peak; the one-rank point of
   bench.scaling with telemetry.
Then prints one JSON line of per-kernel results and, last, the device line.
Each kernel's launches there are those of the main paths that run it: the
respawn kernel's the headline's and the sharded path's; the one-shot
kernel's both fits, the one-shot engine's frame, the CLI's, the sharded
path's and the tooling's CLI and scaling point; the backward kernel's both
fits and the sharded path's; the soft modes' the soft geometry fit's and
the soft camera fits' (their times and bounds are on the same shape); the
hard camera steps' have entries of their own (oneshot_camera,
mega_backward_camera), with times and bounds on the camera fit's frame;
the index kernel's the pipeline fit, the giant step and the sharded
pipeline step; the phase kernel's the wavefront frame and the sharded
one; the kIters instantiations' (respawn_iters, oneshot_iters) the
sharded path's telemetry and the scaling point's. The kIters entries' times and bounds: the
respawn kernel's at compare's first case, as the respawn entry's; the
one-shot kernel's on the CLI frame. Times and
bounds: the gradient kernels' on the medium frame, the index kernel's on
one chunk of the medium fit (131,072 rays), the phase kernel's summed over
the phases of the wavefront frame; max_abs_err is the worst of every
comparison. The soft modes of the one-shot and backward kernels have
entries of their own: launches those of the soft fit, times and bounds on
its whole frame. Any failure raises and exits non-zero before the last
line.

Bounds: a kernel's bound is the larger of its bytes (each input read once,
each output written once) over HBM_BYTES_PER_S and its FP32 operations over
FP32_OPS_PER_S. The kernels are built with --fmad=false, so an add or a
multiply is one instruction: the card's 67 TFLOP/s FP32 peak counts a fused
multiply-add as two operations, and a stream of plain adds and multiplies
peaks at half of it. Operations are counted from this run's data: a sweep
costs SWEEP_OPS per sphere row and traced ray, a replayed bounce of the
backward BACKWARD_OPS per live bounce. The soft one-shot kernel adds the
graze sweep: GRAZE_OPS per row and traced ray, and for the square roots
this run's rays take (counted by the plain version) HARD_ROOT_OPS per root
of the hard sweep and GRAZE_ROOT_OPS per root of the graze sweep. The soft
backward costs SOFT_BACKWARD_OPS per live bounce.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rays1bench_tpu_torch.bench import grad as bench_grad
from rays1bench_tpu_torch.bench.grad import (ALBEDOS, GEOMETRY, cuda_ms,
                                             geometry_config, kernel_ms,
                                             launch_ms, moved_geometry,
                                             perturb_albedos, phase_ms)
from rays1bench_tpu_torch.bench import camfit as camfit_bench
from rays1bench_tpu_torch.bench import cli, report, scaling
from rays1bench_tpu_torch.bench.gradcase import (random_cts, save_case,
                                                 soa_grads, summed_scales)
from rays1bench_tpu_torch.bench.harness import benchmark_sustained
from rays1bench_tpu_torch.core.config import RenderConfig, get_config
from rays1bench_tpu_torch.grad import inverse, mega
from rays1bench_tpu_torch.grad.inverse import (InverseConfig, fit_scene,
                                               make_train_step, params_of,
                                               render_for_loss, with_params)
from rays1bench_tpu_torch.kernels import (build, intersect_index,
                                          mega_backward, megakernel)
from rays1bench_tpu_torch.kernels.pipeline import (image_of_rays,
                                                   prepare_trimmed,
                                                   ray_coords,
                                                   render_image_megakernel)
from rays1bench_tpu_torch.parallel import shard
from rays1bench_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
from rays1bench_tpu_torch.parallel.shard import render_image_pallas_sharded
from rays1bench_tpu_torch.render.pipeline import (primary_rays, render_image,
                                                  to_srgb_u8)
from rays1bench_tpu_torch.runtime import native
from rays1bench_tpu_torch.scene import builders, tga
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS
from rays1bench_tpu_torch.scene.spheres import prepare
from rays1bench_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "latest_full_large.tga")

# Kernel vs plain version, both on the card. The kernel is compiled with
# --fmad=false and IEEE division and sqrt, and every torch op is its own
# IEEE float32 op, so the two should agree bit for bit.
SUM_TOL = 0.0
# A two-span split adds the two partial sums once instead of adding the
# samples one by one, and the one-shot engine's image is a torch mean over
# the spp axis where the respawn engine's is a serial sample sum times
# 1/spp: float addition order only.
SPLIT_TOL = 1e-5
REFERENCE_RAYS = 631_145_620   # tests/golden/README.md:15-19
RAY_TOL = 3e-3                 # tests/test_pipeline.py:88
GOLDEN_TOL_MEAN, GOLDEN_TOL_MAX, BLOCK = 1.25, 3.5, 16   # tools/verify_golden.py
HEADLINE = RenderConfig(width=1280, height=720, spp=250, max_bounces=50)
PIXEL_SEED = 7
# Lane occupancy (occupancy): the pixels a warp covers under a loop nest
# over samples then bounces on 16x8-pixel blocks, and under the respawn
# kernel's flat loop; a 160x90 crop of the headline, aligned to both.
NESTED_WARP = (16, 2)
FLAT_WARP = (8, 4)
OCC_CROP = (560, 316, 160, 90)

# The fused backward against backward_reference: both float32, but the
# kernel adds its column sums with atomics in an order that changes from
# run to run and follows its hand-derived adjoint's operation order, where
# autograd follows its own. Max abs gap per column (and per ray plane) over
# the column's max abs value. Host-compiled rehearsal of the same adjoint
# against autograd: <= 2.5e-5.
GRAD_TOL = 1e-3
# Where a failed gradient check's inputs are saved (git-ignored).
CASE_DIR = os.path.join(REPO, "tmp", "grad_cases")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak rate
FP32_OPS_PER_S = 67e12 / 2     # non-fused FP32 adds and multiplies
# FP32 adds and multiplies per sphere test on the sweep's miss path: 9 FADD
# and 7 FMUL in the sm_90a SASS (python -m rays1bench_tpu_torch.bench.sass).
SWEEP_OPS = 16
# FP32 operations of one live bounce in the fused backward, counted by hand
# from path_math.cuh and path_adjoint.cuh on the cheapest hit path
# (lambertian): the forward replay (hit record 33, scatter 59 with the
# ball's sincos polynomials and the IEEE sqrt and divide sequences,
# attenuation 3) and the reverse (its recompute 33, the ball again 36,
# normalize3's adjoint 38, the rest of the chain 70). Metal and glass cost
# more and a miss less; the bound is set by bytes at these shapes anyway.
BACKWARD_OPS = 270
FIT_SEED = 5
SUBSET_SEED = 9
REFILL_SEED = 12
PLAIN_CHUNK = 1 << 19

GRAD_CASES = [  # (name, scene, width, height, spp, max_bounces, pad)
    ("small 64x32 @ 2 spp @ 3 b", "small", 64, 32, 2, 3, 8),
    ("small 64x32 @ 2 spp @ 5 b", "small", 64, 32, 2, 5, 8),
    ("medium 160x90 @ 4 spp @ 10 b", "medium", 160, 90, 4, 10, 8),
    ("large 160x90 @ 4 spp @ 10 b (512 rows)", "large", 160, 90, 4, 10, 128),
]
FULL = dict(width=1280, height=720, spp=4, max_bounces=10, seed=FIT_SEED,
            early_exit=False)

WAVEFRONT = (2, 3, 6)
PHASE_CASES = [  # (name, scene, width, height, spp, max_bounces, schedules)
    ("small 64x32 @ 8 spp @ 6 b (hollow glass)", "small", 64, 32, 8, 6,
     [(2, 5), (2, 3, 6), (1,)]),
    ("small 64x32 @ 8 spp @ 3 b (budget runs out)", "small", 64, 32, 8, 3,
     [(2, 3, 6)]),
    ("small 50x30 @ 2 spp @ 4 b (ragged)", "small", 50, 30, 2, 4,
     [(2, 5), (2, 3, 6), (1,)]),
]
# Bytes a listed ray moves through one phase: 12 state floats in and out,
# its id, slot and alive flag in, alive out, its count in and out.
PHASE_RAY_BYTES = 12 * 4 * 2 + 4 + 4 + 1 + 1 + 4 * 2
# The soft one-shot kernel's graze sweep, counted from path_math.cuh: per
# row and traced ray co = c - o and nb = co.d (3 FADD, 3 FMUL, 2 FADD); per
# row passing its cheap tests |co|^2, |co|^2 - nb^2 and the edge (3 FMUL,
# 2 FADD, 1 FMUL, 1 FADD, 1 FADD) and the root; per root of the hard sweep
# the root and the two candidate t (2 FADD). A root counts as one
# operation.
GRAZE_OPS = 8
GRAZE_ROOT_OPS = 9
HARD_ROOT_OPS = 3
# The soft replayed bounce over BACKWARD_OPS, counted by hand from
# path_adjoint.cuh: the forward's renormalized normal, edge, cover, far
# exit and branch weights (~30 FP32 operations; the sigmoid's float64 exp
# not counted) and the reverse's normalize3 adjoint and cover chain (~35).
SOFT_BACKWARD_OPS = BACKWARD_OPS + 65
SOFT = 0.005
SOFT_CASES = [  # (name, scene, width, height, spp, max_bounces, pad)
    ("small 64x32 @ 2 spp @ 4 b (hollow glass)", "small", 64, 32, 2, 4, 8),
    ("small 50x30 @ 2 spp @ 4 b (ragged)", "small", 50, 30, 2, 4, 8),
    ("medium 160x90 @ 4 spp @ 10 b (48 rows)", "medium", 160, 90, 4, 10, 8),
]
SOFT_FIT = dict(width=1280, height=720, spp=4, max_bounces=10,
                seed=GEOMETRY["small"][0], early_exit=False,
                soft_silhouette=SOFT)
SOFT_FIT_STEPS = 150
RECOVERY = 0.3                 # tools/fullres_fit_probe.py:116
INDEX_CHUNK = 131072           # RenderConfig.ray_chunk, the pipeline's chunk
INDEX_PLAIN_CHUNK = 65536      # (65,536 x 4,096) float temporaries: ~1 GB each

# The sharded path's local checks: a 4-way tile mesh and a 2x2 (tiles,
# samples) mesh.
SHARD_SHAPES = ((4, 1), (2, 2))
# The camera fit at full width: the JAX recipe (tests/test_grad.py:514-549,
# bench.camfit.CASES) at 1280x720 @ 4 spp @ 10 b.
CAMFIT = dict(width=1280, height=720, spp=4, max_bounces=10, seed=3,
              early_exit=False)
CAMFIT_STEPS = 120
# The __global__ function of each kernel, as a profiler trace names it.
TRACE_FUNCTIONS = dict(bench_grad.KERNELS, respawn="respawn_kernel",
                       phase="phase_kernel")

CASES = [  # (name, scene, width, height, spp, max_bounces)
    ("large 160x90 @ 4 spp @ 10 b", "large", 160, 90, 4, 10),
    ("small 64x32 @ 8 spp @ 6 b (hollow glass)", "small", 64, 32, 8, 6),
    ("small 50x30 @ 2 spp @ 4 b (ragged blocks)", "small", 50, 30, 2, 4),
    ("giant 32x16 @ 2 spp @ 4 b (114,688 B table)", "giant", 32, 16, 2, 4),
]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def packed_inputs(scene_name, cfg):
    """The packed tables render_image_megakernel gives the kernel."""
    scene = builders.SCENES[scene_name](cfg.aspect, device="cuda")
    spheres = prepare_trimmed(scene.spheres, scene.n_real)
    cam = scene.camera.build("cuda")
    return megakernel.pack_spheres(spheres), megakernel.pack_camera(cam)


def count_and_sum_gaps(label, k_cnt, k_rad, p_cnt, p_rad):
    """Raise unless per-pixel counts are equal and sums within SUM_TOL;
    returns (pixels with a count gap, sum channels differing, max abs gap)."""
    cnt_diff = int((k_cnt != p_cnt).sum())
    err = max(float((a - b).abs().max()) for a, b in zip(k_rad, p_rad))
    n_diff = sum(int((a != b).sum()) for a, b in zip(k_rad, p_rad))
    if cnt_diff:
        raise AssertionError(f"{label}: ray counts differ at {cnt_diff} pixels")
    if not err <= SUM_TOL:
        raise AssertionError(f"{label}: sample sums differ by {err}")
    return cnt_diff, n_diff, err


def compare_case(label, scene_name, w, h, spp, mb):
    """Kernel vs plain version on the card; returns (max_abs_err, kernel
    ms, plain ms, (bound ms, bound by))."""
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb)
    packed, cam = packed_inputs(scene_name, cfg)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device="cuda")
    x = (pid % w).to(torch.float32)
    y = (pid // w).to(torch.float32)

    megakernel.trace_respawn(packed, cam, cfg)  # warm
    (k_rad, k_cnt, k_total), k_ms = cuda_ms(
        lambda: megakernel.trace_respawn(packed, cam, cfg), reps=3)
    (p_rad, p_cnt), p_ms = cuda_ms(
        lambda: megakernel.trace_respawn_reference(packed, cam, pid, x, y, cfg))

    print(f"[compare] {label}: rays {int(k_total)} kernel / "
          f"{int(p_cnt.sum(dtype=torch.int64))} plain | kernel {k_ms:.3f} ms, "
          f"plain {p_ms:.1f} ms", flush=True)
    cnt_diff, n_diff, err = count_and_sum_gaps(label, k_cnt, k_rad, p_cnt,
                                               p_rad)
    print(f"[compare] {label}: pixels with a count gap {cnt_diff}, sum "
          f"channels differing {n_diff}, max abs sum gap {err:.3e}",
          flush=True)
    if int(k_total) != int(p_cnt.sum(dtype=torch.int64)):
        raise AssertionError(f"{label}: ray totals differ")

    # Two spans summed against the full span.
    k = spp // 2
    (a_rad, a_cnt, a_tot) = megakernel.trace_respawn(packed, cam, cfg, (0, k))
    (b_rad, b_cnt, b_tot) = megakernel.trace_respawn(packed, cam, cfg, (k, spp))
    split_err = max(float((a + b - c).abs().max())
                    for a, b, c in zip(a_rad, b_rad, k_rad))
    print(f"[compare] {label}: split [0,{k})+[{k},{spp}) max abs gap "
          f"{split_err:.3e}", flush=True)
    if not torch.equal(a_cnt + b_cnt, k_cnt) or \
            int(a_tot) + int(b_tot) != int(k_total):
        raise AssertionError(f"{label}: split ray counts differ")
    if not split_err <= SPLIT_TOL:
        raise AssertionError(f"{label}: split sums differ by {split_err}")

    # The kIters instantiation: the same outputs, and trips equal to the
    # plain twin of the plain version's per-pixel counts.
    megakernel.trace_respawn(packed, cam, cfg, debug_iters=True)  # warm
    (i_rad, i_cnt, i_total, i_iters), i_ms = cuda_ms(
        lambda: megakernel.trace_respawn(packed, cam, cfg, debug_iters=True),
        reps=3)
    _, _, i_err = count_and_sum_gaps(f"{label}, kIters", i_cnt, i_rad, p_cnt,
                                     p_rad)
    twin, t_ms = cuda_ms(lambda: megakernel.respawn_iters_reference(p_cnt, w))
    print(f"[compare] {label}: kIters kernel {i_ms:.3f} ms (without "
          f"{k_ms:.3f}): outputs equal to the plain version's; warp trips "
          f"{int(i_iters)}, plain twin {int(twin)} ({t_ms:.2f} ms)",
          flush=True)
    if int(i_iters) != int(twin) or int(i_total) != int(k_total):
        raise AssertionError(f"{label}: kIters trips {int(i_iters)} against "
                             f"the plain twin's {int(twin)}")
    bound = respawn_bound(cfg.num_pixels, packed.shape[1], int(k_total))
    return (err, k_ms, p_ms, bound,
            (i_err, i_ms, p_ms + t_ms, respawn_bound(
                cfg.num_pixels, packed.shape[1], int(k_total), 8)))


def reset_launches():
    megakernel.LAUNCHES = 0
    megakernel.ONESHOT_LAUNCHES = 0
    megakernel.PHASE_LAUNCHES = 0
    megakernel.RESPAWN_ITERS_LAUNCHES = 0
    megakernel.ONESHOT_ITERS_LAUNCHES = 0
    mega_backward.LAUNCHES = 0
    intersect_index.LAUNCHES = 0


def bound_ms(n_bytes, n_ops):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def respawn_bound(npix, s_count, rays, extra=0):
    """Table and camera in, 3 sums and a count per pixel out (and `extra`
    bytes: the kIters trip total); a sweep of every row per traced ray."""
    return bound_ms(4 * (7 * s_count + 19 + 4 * npix) + extra,
                    rays * s_count * SWEEP_OPS)


def oneshot_bound(n, s_count, mb, rays):
    """Table, 6 ray planes and ids in; radiance, count and mb+1 topology
    planes out; a sweep of every row per traced ray."""
    return bound_ms(4 * (7 * s_count + n * (7 + 4 + mb + 1)),
                    rays * s_count * SWEEP_OPS)


def backward_bound(n, s_count, mb, live):
    """Exact table, rays, ids, 3 cotangents and mb+1 topology planes in;
    10 x S column sums and 6 ray planes out; a replayed and reversed bounce
    per live bounce."""
    return bound_ms(4 * (21 * s_count + n * (10 + mb + 1 + 6)),
                    live * BACKWARD_OPS)


def index_bound(n, s_count):
    """The (4, S) table and six ray planes in, an int32 index and a bool per
    ray out; a sphere test per row and ray."""
    return bound_ms(4 * 4 * s_count + n * (6 * 4 + 4 + 1),
                    n * s_count * SWEEP_OPS)


def phase_bound(s_count, phases, listed, rays):
    """The table once per phase and PHASE_RAY_BYTES per listed ray; a sweep
    of every row per traced ray."""
    return bound_ms(4 * 7 * s_count * phases + listed * PHASE_RAY_BYTES,
                    rays * s_count * SWEEP_OPS)


def grad_inputs(scene_name, cfg, pad):
    """(scene, prepared spheres, primary rays, ray ids) on the card, rays in
    ray-id order."""
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=pad,
                                        device="cuda")
    camera = scene.camera.build("cuda")
    ray_id, x, y = ray_coords(cfg, "cuda")
    rays = [r.contiguous() for r in primary_rays(camera, cfg, x, y, ray_id)]
    return scene, prepare(scene.spheres), rays, ray_id


def topology_gap(label, k, p):
    """k, p: (radiance, counts, topology) of kernel and plain version; raise
    unless equal bit for bit; returns the max abs radiance gap."""
    (k_rad, k_cnt, k_topo), (p_rad, p_cnt, p_topo) = k, p
    n_topo = int((k_topo != p_topo).sum())
    n_cnt = int((k_cnt != p_cnt).sum())
    err = max(float((a - b).abs().max()) for a, b in zip(k_rad, p_rad))
    if n_topo or n_cnt or not err <= SUM_TOL:
        raise AssertionError(f"{label}: topology kernel vs plain version: "
                             f"{n_topo} topology entries and {n_cnt} counts "
                             f"differ, radiance gap {err}")
    return err


def grad_gap(label, k, p, n_real, scales=None):
    """k, p: (grads, ray cotangents) of kernel and plain version; raise
    unless every column and ray plane is within GRAD_TOL, placeholder rows
    are exactly 0 and all is finite; returns (worst relative gap, max abs
    gap). The gap of a column is over its max abs value, or, where scales
    (aligned with the columns and then the planes) gives a summed scale
    for it, over that scale's max (bench.gradcase.summed_scales)."""
    got = list(k[0]) + list(k[1])
    want = list(p[0]) + list(p[1])
    scales = scales or [None] * len(got)
    rel = max(float((a - b).abs().max() / (b.abs() if s is None else s)
                    .max().clamp_min(1e-30))
              for a, b, s in zip(got, want, scales))
    if any(s is not None for s in scales):
        over_sum = max(float((a - b).abs().max()
                             / b.abs().max().clamp_min(1e-30))
                       for a, b in zip(got, want))
        print(f"[grad] {label}: worst gap over max |sum| {over_sum:.2e} (not "
              f"checked), over the summed scales {rel:.2e}", flush=True)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not all(bool(torch.isfinite(a).all()) for a in got):
        raise AssertionError(f"{label}: non-finite cotangents")
    if k[0].shape[1] > n_real and float(k[0][:, n_real:].abs().max()) != 0:
        raise AssertionError(f"{label}: placeholder rows got a gradient")
    if not rel <= GRAD_TOL:
        raise AssertionError(f"{label}: fused backward vs backward_reference "
                             f"relative gap {rel}")
    return rel, err


def grad_case(label, scene_name, w, h, spp, mb, pad, soft=0.0):
    """Both gradient kernels against their plain versions on the card, in
    the soft-silhouette mode when soft > 0; returns (topology radiance gap,
    backward max abs gap)."""
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb,
                       seed=FIT_SEED, early_exit=False, soft_silhouette=soft)
    scene, prep, rays, ray_id = grad_inputs(scene_name, cfg, pad)
    packed = megakernel.pack_spheres(prep)
    fwd = lambda: megakernel.trace_topology(packed, *rays, ray_id, cfg)
    fwd()
    (k_rad, k_cnt, k_total, topo), a_ms, _, _ = launch_ms(fwd)
    stats = {}
    plain, a_plain_ms = cuda_ms(lambda: megakernel.trace_topology_reference(
        packed, *rays, ray_id, cfg, stats=stats))
    a_err = topology_gap(label, (k_rad, k_cnt, topo), plain)
    if int(k_total) != int(k_cnt.sum(dtype=torch.int64)):
        raise AssertionError(f"{label}: topology kernel ray total differs")
    if soft:
        soft_counts(label, stats)
    cts = random_cts(ray_id.numel(), 1)
    bwd = lambda: mega_backward.backward(prep, *rays, ray_id, *cts, topo,
                                         cfg)
    bwd()
    k, b_ms, _, _ = launch_ms(bwd)
    p, b_plain_ms = cuda_ms(lambda: mega_backward.backward_reference(
        prep, *rays, ray_id, *cts, topo, cfg))
    rel, b_err = gradient_gap(label, k, p, scene.spheres, scene.n_real,
                              (scene_name, scene.spheres, cfg, cts, 1, None))
    print(f"[grad] {label}{f', soft {soft}' if soft else ''}: {prep.count} "
          f"rows, {int(k_total)} rays | topology kernel {a_ms:.3f} ms, plain "
          f"{a_plain_ms:.1f} ms: topology, counts and radiance equal | fused "
          f"backward {b_ms:.3f} ms, plain {b_plain_ms:.1f} ms: worst "
          f"relative gap {rel:.2e}, max abs gap {b_err:.2e}", flush=True)
    return a_err, b_err


def fit(scene_name, pad, steps):
    """The gradient path: fit_scene from perturbed albedos to the scene's
    own render through the same engine. Returns (scene, camera, cfg,
    fitted spheres, (topology launches, backward launches))."""
    cfg = RenderConfig(**FULL)
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=pad,
                                        device="cuda")
    camera = scene.camera.build("cuda")
    with torch.no_grad():
        target = render_for_loss(scene.spheres, camera, cfg)
    start = perturb_albedos(scene.spheres, scene.n_real)
    inv = InverseConfig(learning_rate=1e-2, steps=steps, optimize=ALBEDOS)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, losses = fit_scene(start, camera, target, cfg, inv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (megakernel.ONESHOT_LAUNCHES, mega_backward.LAUNCHES)
    label = (f"{scene_name} ({scene.spheres.count} rows) {cfg.width}x"
             f"{cfg.height} @ {cfg.spp} spp @ {cfg.max_bounces} b")
    # The same step again, warm: make_train_step is what fit_scene runs.
    step, _ = make_train_step(fitted, camera, cfg, inv,
                              params_of(fitted, ALBEDOS))
    step(target)
    _, step_ms = cuda_ms(lambda: [step(target) for _ in range(3)])
    print(f"[fit] {label}: {steps} Adam steps in {wall * 1e3:.1f} ms wall "
          f"({wall * 1e3 / steps:.1f} ms a step, first-call set-up "
          f"included), warm {step_ms / 3:.2f} ms a step (CUDA events, 3 "
          f"steps); losses {', '.join(f'{x:.6e}' for x in losses)}; "
          f"launches topology {launches[0]} backward {launches[1]}",
          flush=True)
    if min(launches) < steps:
        raise AssertionError(f"{label}: the fit did not launch both kernels "
                             f"every step: {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss")
    if steps > 1 and not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall")
    return scene, camera, cfg, fitted, launches


def kernels_alone(name, scene, camera, cfg, fitted):
    """Print each gradient kernel's time alone on the fitted scene
    (bench.grad.kernel_ms), beside its bound."""
    ms, launches, traced = kernel_ms(fitted, camera, cfg)
    n, rows = cfg.num_primary_rays, scene.spheres.count
    a_bound = oneshot_bound(n, rows, cfg.max_bounces, traced)
    b_bound = backward_bound(n, rows, cfg.max_bounces, traced)
    each = lambda k: ", ".join(f"{d:.3f}/{h:.3f}" for d, h in zip(
        launches[k]["device"], launches[k]["host"]))
    print(f"[fit] {name}: kernels alone on the fitted scene, {traced} rays: "
          f"topology {ms['oneshot']:.3f} ms (bound {a_bound[0]:.4f} ms, "
          f"{a_bound[1]}), fused backward {ms['mega_backward']:.3f} ms "
          f"(bound {b_bound[0]:.4f} ms, {b_bound[1]}); device/host ms of "
          f"each launch: topology {each('oneshot')}, backward "
          f"{each('mega_backward')}", flush=True)


def subset_rays(cfg):
    """Ray ids of ~4k rays of the frame: a 32x16 pixel block, every 4th
    pixel of the last column, every 8th of the top row (row 0 is the
    bottom), the four corners and 150 pixels from SUBSET_SEED; all spp
    samples of each."""
    w, h = cfg.width, cfg.height
    block = [y * w + x for y in range(360, 376) for x in range(640, 672)]
    last_column = [y * w + w - 1 for y in range(0, h, 4)]
    top_row = [(h - 1) * w + x for x in range(0, w, 8)]
    corners = [0, w - 1, (h - 1) * w, h * w - 1]
    spread = np.random.default_rng(SUBSET_SEED).integers(0, w * h, 150)
    pix = np.unique(np.concatenate([block, last_column, top_row, corners,
                                    spread]))
    rid = (pix[:, None] * cfg.spp + np.arange(cfg.spp)).reshape(-1)
    return torch.from_numpy(rid).to("cuda")


def plain_chunked(fn, n, *per_ray):
    """fn over chunks of PLAIN_CHUNK rays; per_ray: tensors whose last axis
    is the ray. Returns the list of fn's results."""
    return [fn(*(t[..., lo:lo + PLAIN_CHUNK] for t in per_ray))
            for lo in range(0, n, PLAIN_CHUNK)]


def full_width(name, fitted, camera, cfg, n_real):
    """The gradient kernels at the fit's shape, against their plain versions
    over the whole frame (in chunks of rays) and on ~4k rays launched as
    their own list, in the soft mode when cfg has it. Returns per-kernel
    (max abs gap, ms, plain ms, bound)."""
    soft = cfg.soft_silhouette
    label = (f"{name} ({fitted.count} rows) {cfg.width}x{cfg.height} @ "
             f"{cfg.spp} spp @ {cfg.max_bounces} b"
             + (f", soft {soft}" if soft else ""))
    prep = prepare(fitted)
    ray_id, x, y = ray_coords(cfg, "cuda")
    rays = [r.contiguous() for r in primary_rays(camera, cfg, x, y, ray_id)]
    n, s_count, mb = ray_id.numel(), prep.count, cfg.max_bounces
    packed = megakernel.pack_spheres(prep)

    fwd = lambda: megakernel.trace_topology(packed, *rays, ray_id, cfg)
    fwd()
    (k_rad, k_cnt, k_total, topo), a_ms, _, _ = launch_ms(fwd)
    stats = {}
    parts, a_plain_ms = cuda_ms(lambda: plain_chunked(
        lambda *t: megakernel.trace_topology_reference(packed, *t, cfg,
                                                       stats=stats), n,
        *rays, ray_id))
    plain = (tuple(torch.cat([q[0][c] for q in parts]) for c in range(3)),
             torch.cat([q[1] for q in parts]),
             torch.cat([q[2] for q in parts], dim=1))
    a_err = topology_gap(label, (k_rad, k_cnt, topo), plain)
    rays_traced = int(k_total)
    if soft:
        soft_counts(label, stats)

    cts = random_cts(n, 2)
    bwd = lambda: mega_backward.backward(prep, *rays, ray_id, *cts, topo, cfg)
    bwd()
    (k_grads, k_cts), b_ms, _, _ = launch_ms(bwd)
    parts, b_plain_ms = cuda_ms(lambda: plain_chunked(
        lambda *t: mega_backward.backward_reference(prep, *t[:7], *t[7:10],
                                                    t[10], cfg), n,
        *rays, ray_id, *cts, topo))
    p_grads = sum(q[0] for q in parts)
    p_cts = [torch.cat([q[1][c] for q in parts]) for c in range(6)]
    rel, b_err = gradient_gap(label, (k_grads, k_cts), (p_grads, p_cts),
                              fitted, n_real, (name, fitted, cfg, cts, 2,
                                               None), [q[0] for q in parts])
    if soft:
        a_bound = soft_oneshot_bound(n, s_count, mb, rays_traced, stats)
        b_bound = soft_backward_bound(n, s_count, mb, rays_traced)
    else:
        a_bound = oneshot_bound(n, s_count, mb, rays_traced)
        b_bound = backward_bound(n, s_count, mb, rays_traced)
    print(f"[full] {label}: {n} rays, {rays_traced} traced"
          + (f", roots hard {stats['hard_roots']} graze "
             f"{stats['graze_roots']}" if soft else "")
          + f" | topology kernel {a_ms:.3f} ms (bound {a_bound[0]:.4f} ms, "
          f"{a_bound[1]}), plain {a_plain_ms:.1f} ms (chunks of "
          f"{PLAIN_CHUNK}): equal | fused backward {b_ms:.3f} ms (bound "
          f"{b_bound[0]:.4f} ms, {b_bound[1]}), plain {b_plain_ms:.1f} ms: "
          f"worst relative gap {rel:.2e}, max abs gap {b_err:.2e}",
          flush=True)

    perm = torch.randperm(n, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(REFILL_SEED))
    q_rad, q_cnt, _, q_topo = megakernel.trace_topology(
        packed, *(r[perm].contiguous() for r in rays),
        ray_id[perm].contiguous(), cfg)
    topology_gap(f"{label}, the frame's rays in a seeded order",
                 (q_rad, q_cnt, q_topo),
                 ([r[perm] for r in k_rad], k_cnt[perm], topo[:, perm]))

    idx = subset_rays(cfg)
    sub = [r[idx].contiguous() for r in rays]
    sub_id = ray_id[idx].contiguous()
    s_rad, s_cnt, _, s_topo = megakernel.trace_topology(packed, *sub, sub_id,
                                                        cfg)
    topology_gap(f"{label}, {idx.numel()} rays vs the frame",
                 (s_rad, s_cnt, s_topo),
                 ([r[idx] for r in k_rad], k_cnt[idx], topo[:, idx]))
    topology_gap(f"{label}, {idx.numel()} rays vs plain",
                 (s_rad, s_cnt, s_topo),
                 megakernel.trace_topology_reference(packed, *sub, sub_id,
                                                     cfg))
    s_cts = [c[idx].contiguous() for c in cts]
    s_grads, s_ray_cts = mega_backward.backward(prep, *sub, sub_id, *s_cts,
                                                s_topo.contiguous(), cfg)
    n_diff = sum(int((a != b[idx]).sum()) for a, b in zip(s_ray_cts, k_cts))
    if n_diff:
        raise AssertionError(f"{label}: {n_diff} ray cotangents of the "
                             f"{idx.numel()}-ray launch differ from the "
                             f"frame's")
    s_rel, _ = gradient_gap(f"{label}, {idx.numel()} rays",
                            (s_grads, s_ray_cts),
                            mega_backward.backward_reference(
                                prep, *sub, sub_id, *s_cts, s_topo, cfg),
                            fitted, n_real, (name, fitted, cfg, s_cts, 2,
                                             sub_id))
    print(f"[full] {label}, {idx.numel()} rays launched alone: topology, "
          f"counts, radiance and ray cotangents equal to the frame's launch "
          f"bit for bit; against the plain versions topology equal, "
          f"backward worst relative gap {s_rel:.2e}; the frame's rays in a "
          f"seeded order: topology, counts and radiance equal to the "
          f"frame's launch", flush=True)
    return ((a_err, a_ms, a_plain_ms, a_bound),
            (b_err, b_ms, b_plain_ms, b_bound))


def soft_oneshot_bound(n, s_count, mb, rays, stats):
    """oneshot_bound's bytes; the hard sweep's SWEEP_OPS and the graze
    sweep's GRAZE_OPS per row and traced ray, and the roots this run took
    (stats of trace_topology_reference)."""
    return bound_ms(4 * (7 * s_count + n * (7 + 4 + mb + 1)),
                    rays * s_count * (SWEEP_OPS + GRAZE_OPS)
                    + stats["hard_roots"] * HARD_ROOT_OPS
                    + stats["graze_roots"] * GRAZE_ROOT_OPS)


def soft_backward_bound(n, s_count, mb, live):
    return bound_ms(4 * (21 * s_count + n * (10 + mb + 1 + 6)),
                    live * SOFT_BACKWARD_OPS)


def soft_grad_gap(label, k, p, soa, n_real, chunks=None):
    """grad_gap for the soft mode: every column but the raw inv_radius one
    (rounding noise there: the soft normal is renormalized, so its exact
    derivative is 0), the ray planes, and the scene's own columns chained
    through prepare, within GRAD_TOL; the summed columns over their summed
    scales where chunks gives the plain version's per-chunk grads. Prints
    the inv_radius column's gap; returns (worst relative gap, max abs
    gap)."""
    noise = mega_backward.GRAD_ROWS.index("inv_radius")
    keep = [r for r in range(mega_backward.NUM_GRAD) if r != noise]
    scales = None
    if chunks:
        per = summed_scales(soa, chunks)
        scales = ([per[f"grad {mega_backward.GRAD_ROWS[r]}"] for r in keep]
                  + [None] * 6 + [per[f"scene {c}"] for c in COLUMNS
                                  if c != "mat_type"])
    out = grad_gap(label, (k[0][keep], list(k[1]) + soa_grads(soa, k[0])),
                   (p[0][keep], list(p[1]) + soa_grads(soa, p[0])), n_real,
                   scales)
    if k[0].shape[1] > n_real and float(k[0][:, n_real:].abs().max()) != 0:
        raise AssertionError(f"{label}: placeholder rows got a gradient")
    ivr = float((k[0][noise] - p[0][noise]).abs().max()
                / p[0][noise].abs().max().clamp_min(1e-30))
    print(f"[soft] {label}: raw inv_radius column relative gap {ivr:.2e} "
          f"(not checked)", flush=True)
    return out


def gradient_gap(label, k, p, soa, n_real, case, chunks=None):
    """The gradient check of the mode of case's config (soft_grad_gap or
    grad_gap). case: (scene name, SphereSOA, RenderConfig, cotangents,
    cotangent seed, ray ids or None), the check's inputs; on a failure they
    are saved under CASE_DIR (bench.gradcase.save_case) before it raises.
    chunks: the plain version's grads chunk by chunk where it summed the
    frame in chunks of rays; the column sums are then held to GRAD_TOL of
    their summed scales, not of max |sum|. Where a column's terms cancel,
    one ray's term can outweigh the sum many times over: in a fitted soft
    scene, a ray bouncing between rows 2 and 1 for ten segments carried a
    fuzz cotangent of -65.8 against a frame sum of 4.17, and the kernel and
    the plain version, both float32, agree on that term to 2e-5 of itself
    (tests/test_torch_host_kernels.py, the trapped ray), which is 3e-4 of
    the sum; float64 moves the term by 8%."""
    try:
        if case[2].soft_silhouette:
            return soft_grad_gap(label, k, p, soa, n_real, chunks)
        scales = (None if chunks is None else
                  list(sum(c.abs() for c in chunks)) + [None] * 6)
        return grad_gap(label, k, p, n_real, scales)
    except AssertionError:
        d = save_case(CASE_DIR, label, *case)
        print(f"[case] {label}: failed gradient check, inputs saved in {d}",
              flush=True)
        raise


def soft_counts(label, stats):
    print(f"[soft] {label}: promoted lanes {stats['promoted']}, pass-through "
          f"draws {stats['pass_through']} (live lanes, plain version, equal "
          f"to the kernel's run)", flush=True)
    if not (stats["promoted"] > 0 and stats["pass_through"] > 0):
        raise AssertionError(f"{label}: no promoted lane or no pass-through "
                             f"draw: {stats}")


def soft_fit():
    """The soft path: the full-resolution geometry fit through
    fit_scene(engine="mega"). Returns (scene, camera, cfg, fitted spheres,
    (topology launches, backward launches), ms a step)."""
    cfg = RenderConfig(**SOFT_FIT)
    scene = builders.SCENES["small"](cfg.aspect, pad_multiple=8,
                                     device="cuda")
    camera = scene.camera.build("cuda")
    with torch.no_grad():
        target = render_for_loss(scene.spheres, camera, cfg, engine="mega")
    start = moved_geometry(scene.spheres, "small")
    inv = geometry_config("small", SOFT_FIT_STEPS)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, losses = fit_scene(start, camera, target, cfg, inv,
                               engine="mega")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (megakernel.ONESHOT_LAUNCHES, mega_backward.LAUNCHES)
    label = (f"small ({scene.spheres.count} rows) {cfg.width}x{cfg.height} "
             f"@ {cfg.spp} spp @ {cfg.max_bounces} b, soft {SOFT}, seed "
             f"{cfg.seed}")
    step_ms = wall * 1e3 / SOFT_FIT_STEPS
    shown = ", ".join(f"{i}: {losses[i]:.4e}"
                      for i in list(range(0, SOFT_FIT_STEPS, 15))
                      + [SOFT_FIT_STEPS - 1])
    print(f"[softfit] {label}: {SOFT_FIT_STEPS} Adam steps (lr "
          f"{inv.learning_rate}) in {wall:.2f} s wall ({step_ms:.2f} ms a "
          f"step, first-call set-up included); launches topology "
          f"{launches[0]} backward {launches[1]}; losses {shown}",
          flush=True)
    fracs = {}
    for c, by_row in GEOMETRY["small"][1].items():
        err = abs(float(getattr(fitted, c)[0]) -
                  float(getattr(scene.spheres, c)[0]))
        fracs[c] = err / abs(by_row[0])
    print(f"[softfit] residual fraction of row 0's initial error: "
          f"{', '.join(f'{c} {f:.4f}' for c, f in fracs.items())} (limit "
          f"{RECOVERY})", flush=True)
    if launches != (2 * SOFT_FIT_STEPS, 2 * SOFT_FIT_STEPS):
        raise AssertionError(f"{label}: launches {launches}, expected two "
                             f"of each kernel a step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss")
    if not all(f < RECOVERY for f in fracs.values()):
        raise AssertionError(f"{label}: geometry not recovered: {fracs}")
    step, _ = make_train_step(fitted, camera, cfg, inv,
                              params_of(fitted, inv.optimize), engine="mega")
    step(target)
    phases = phase_ms(step, target)
    _, warm = cuda_ms(lambda: [step(target) for _ in range(5)])
    print(f"[softfit] warm step {warm / 5:.2f} ms (CUDA events, 5 steps); "
          f"one step's phases "
          f"{', '.join(f'{k} {v:.2f}' for k, v in phases.items())} ms",
          flush=True)
    return scene, camera, cfg, fitted, launches, step_ms


def soft_timings():
    """bench.grad.run with --soft on the small full-resolution recipe and
    the medium stage-2 recipe (band 0.005 * 1280 / width), with the
    kernels' bounds; kernel A's counts the sweeps' per-row operations but
    not the roots, which this path does not count."""
    for scene_name in ("small", "medium"):
        cfg = RenderConfig(width=1280, height=720, spp=4,
                           max_bounces=bench_grad.MAX_BOUNCES,
                           early_exit=False, seed=GEOMETRY[scene_name][0],
                           soft_silhouette=SOFT)
        out = bench_grad.run(scene_name, cfg, steps=8)
        prof = out["profiled_steps"] or {}
        n, rows, rays = cfg.num_primary_rays, out["rows"], out["rays_per_step"]
        a_bound = bound_ms(4 * (7 * rows + n * (7 + 4 + cfg.max_bounces + 1)),
                           rays * rows * (SWEEP_OPS + GRAZE_OPS))
        b_bound = soft_backward_bound(n, rows, cfg.max_bounces, rays)
        print(f"[softbench] {scene_name} ({rows} rows) geometry recipe, soft "
              f"{SOFT}: {out['s_per_step'] * 1e3:.2f} ms a step; phases "
              f"{', '.join(f'{k} {v:.2f}' for k, v in out['phase_ms'].items())}"
              f" ms; kernels alone {json.dumps(out['kernel_ms'])} ms, bounds "
              f"A {a_bound[0]:.4f} ms ({a_bound[1]}), B {b_bound[0]:.4f} ms "
              f"({b_bound[1]}) ({rays} rays a render); loss "
              f"{out['loss_first']:.4e} -> {out['loss_last']:.4e}; idle "
              f"share {prof.get('idle_share')}", flush=True)
        print(f"[softbench] {json.dumps(out)}", flush=True)


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bound):
    return {"name": name, "route": "cuda",
            "source": f"rays1bench_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


def block_means(img):
    h, w, c = img.shape
    return img.reshape(h // BLOCK, BLOCK, w // BLOCK, BLOCK, c).mean(axis=(1, 3))


def headline():
    """The main path at the headline workload; returns (kernel launches,
    image, rays per frame)."""
    cfg = HEADLINE
    scene = builders.SCENES["large"](cfg.aspect, device="cuda")
    reset_launches()
    img, rays = render_image_megakernel(scene.spheres,
                                        scene.camera.build("cuda"), cfg,
                                        n_real=scene.n_real)
    res = benchmark_sustained(scene, cfg, frames=2, num_runs=1)
    launches = megakernel.LAUNCHES
    rays = int(rays)
    per_frame = res.elapsed_seconds / 2
    print(f"[headline] large 1280x720 @ 250 spp @ 50 b: rays/frame {rays}, "
          f"2 timed frames {res.num_rays} rays in {res.elapsed_seconds:.3f} s "
          f"= {per_frame:.3f} s/frame, {res.mrays_per_sec:.3f} mrays/s, "
          f"kernel launches {launches}", flush=True)
    if launches < 1:
        raise AssertionError("the main path launched no kernel")
    if res.num_rays != 2 * rays:
        raise AssertionError(f"timed frames traced {res.num_rays} rays, "
                             f"expected 2 x {rays}")
    if not np.isfinite(img.cpu().numpy()).all():
        raise AssertionError("non-finite pixels")
    bound, by = respawn_bound(cfg.num_pixels, 512, rays)
    print(f"[headline] bound {bound:.1f} ms ({by}: {rays} rays x 512 rows x "
          f"{SWEEP_OPS} FP32 ops at {FP32_OPS_PER_S:.3g}/s), "
          f"{bound / (per_frame * 1e3):.3f} of the frame time", flush=True)
    gap = abs(rays - REFERENCE_RAYS) / REFERENCE_RAYS
    print(f"[headline] ray count vs reference {REFERENCE_RAYS}: rel gap "
          f"{gap:.3e} (limit {RAY_TOL})", flush=True)
    if not gap <= RAY_TOL:
        raise AssertionError(f"ray count off by {gap}")

    u8 = to_srgb_u8(img).cpu().numpy()
    path = os.path.join(tempfile.gettempdir(), "rays1bench_tpu_torch_large.tga")
    tga.write_rgb24(path, u8)
    d = np.abs(block_means(u8.astype(np.float64)) -
               block_means(tga.read_rgb24(GOLDEN).astype(np.float64)))
    print(f"[headline] golden 16x16 block means vs latest_full_large.tga: "
          f"mean {d.mean():.3f} max {d.max():.3f} (limits {GOLDEN_TOL_MEAN} / "
          f"{GOLDEN_TOL_MAX}); image {path}", flush=True)
    if not (d.mean() <= GOLDEN_TOL_MEAN and d.max() <= GOLDEN_TOL_MAX):
        raise AssertionError("headline image fails the golden check")
    return launches, img, rays


def headline_pixels(cfg):
    """Pixel ids for the headline plain-version check: one whole 16x8 kernel
    block, the last column, the top row (row 0 is the bottom), the four
    corners and 128 pixels drawn from PIXEL_SEED."""
    w, h = cfg.width, cfg.height
    block = [y * w + x for y in range(360, 368) for x in range(640, 656)]
    last_column = [y * w + w - 1 for y in range(0, h, 12)]
    top_row = [(h - 1) * w + x for x in range(0, w, 20)]
    corners = [0, w - 1, (h - 1) * w, h * w - 1]
    spread = np.random.default_rng(PIXEL_SEED).integers(0, w * h, 128)
    return np.unique(np.concatenate([block, last_column, top_row, corners,
                                     spread]))


def headline_vs_plain(img, rays):
    """Kernel against plain version at the headline's shape. One more kernel
    launch at 1280x720 @ 250 spp @ 50 b must reproduce the main path's image
    and ray count; then the plain version traces a few hundred of its pixels
    on the card. Returns (max abs sum gap, kernel ms, plain ms, pixels,
    the launch's per-pixel counts)."""
    cfg = HEADLINE
    packed, cam = packed_inputs("large", cfg)
    (k_rad, k_cnt, k_total), k_ms = cuda_ms(
        lambda: megakernel.trace_respawn(packed, cam, cfg))
    k_img = torch.stack(k_rad, dim=-1).reshape(cfg.height, cfg.width, 3) * \
        (1.0 / cfg.spp)
    if not torch.equal(k_img, img) or int(k_total) != rays:
        raise AssertionError("the comparison launch does not reproduce the "
                             "main path's frame")
    pid = torch.from_numpy(headline_pixels(cfg)).to("cuda", torch.int32)
    x = (pid % cfg.width).to(torch.float32)
    y = (pid // cfg.width).to(torch.float32)
    (p_rad, p_cnt), p_ms = cuda_ms(
        lambda: megakernel.trace_respawn_reference(packed, cam, pid, x, y, cfg))
    idx = pid.long()
    label = (f"headline large {cfg.width}x{cfg.height} @ {cfg.spp} spp @ "
             f"{cfg.max_bounces} b, {pid.numel()} pixels")
    cnt_diff, n_diff, err = count_and_sum_gaps(
        label, k_cnt[idx], [r[idx] for r in k_rad], p_cnt, p_rad)
    print(f"[compare] {label}: rays {int(p_cnt.sum(dtype=torch.int64))}, "
          f"pixels with a count gap {cnt_diff}, sum channels differing "
          f"{n_diff}, max abs sum gap {err:.3e} | kernel {k_ms:.1f} ms for "
          f"the frame, plain {p_ms:.1f} ms for these pixels", flush=True)
    return err, k_ms, p_ms, pid.numel(), k_cnt


def iters_cost(label, off, on, check):
    """Kernel ms of the kIters = false and true instantiations of one call,
    in turns (off, on, on, off), one call each; check(result of on) raises
    unless its trips are right. Returns (off ms, on ms), each the mean of
    two."""
    ms = {"off": [], "on": []}
    for name in ("off", "on", "on", "off"):
        out, t = cuda_ms(off if name == "off" else on)
        if name == "on":
            check(out)
        ms[name].append(t)
    print(f"[iters] {label}: kIters off {', '.join(f'{t:.3f}' for t in ms['off'])}"
          f" ms, on {', '.join(f'{t:.3f}' for t in ms['on'])} ms (in turns "
          f"off, on, on, off)", flush=True)
    return sum(ms["off"]) / 2, sum(ms["on"]) / 2


def headline_iters(frame_cnt):
    """The respawn kernel's kIters cost at the headline, its trips held to
    the plain twin of the frame's per-pixel counts (frame_cnt, the kernel's
    own without kIters); returns (off ms, on ms, trips)."""
    cfg = HEADLINE
    packed, cam = packed_inputs("large", cfg)
    twin = int(megakernel.respawn_iters_reference(frame_cnt, cfg.width))
    trips = []

    def check(out):
        if not torch.equal(out[1], frame_cnt) or int(out[3]) != twin:
            raise AssertionError(f"headline kIters: trips {int(out[3])} "
                                 f"against the plain twin's {twin}, or "
                                 f"counts differ")
        trips.append(int(out[3]))

    off, on = iters_cost(
        "respawn, headline frame",
        lambda: megakernel.trace_respawn(packed, cam, cfg),
        lambda: megakernel.trace_respawn(packed, cam, cfg, debug_iters=True),
        check)
    segs = int(frame_cnt.sum(dtype=torch.int64))
    print(f"[iters] respawn, headline frame: warp trips {trips[0]} = the "
          f"plain twin's; lane occupancy {segs / (32 * trips[0]):.4f} "
          f"(chip_smoke's occupancy phase: flat loop over the whole "
          f"headline launch)", flush=True)
    return off, on, trips[0]


def warp_occupancy(cnt, tile):
    """Lane occupancy of a warp schedule, from per-pixel segment counts.

    cnt: int tensor (n, H, W), n runs of the frame (or crop) whose warps
    each wait for their slowest lane: one sample each under a loop nest
    that starts a warp's next sample only when all its lanes end theirs,
    or the whole span under the flat loop. tile: (width, height) of the
    pixels one warp covers, aligned to the frame's origin. Returns
    sum cnt / sum over warps and runs of (lanes x max lane count); a warp
    cut by the edge counts only its lanes inside."""
    n, h, w = cnt.shape
    tw, th = tile
    c = torch.nn.functional.pad(cnt.double(), (0, -w % tw, 0, -h % th),
                                value=-1.0)
    c = c.reshape(n, c.shape[1] // th, th, c.shape[2] // tw, tw)
    c = c.permute(0, 1, 3, 2, 4).reshape(n, -1, tw * th)
    paid = (c >= 0).sum(-1) * c.max(-1).values.clamp_min(0.0)
    return float(cnt.sum(dtype=torch.float64)) / float(paid.sum())


def occupancy(frame_cnt):
    """Lane occupancy of a loop nest (a sample at a time,
    NESTED_WARP) on the OCC_CROP crop of the headline, from the plain
    version's per-sample counts, against the flat loop's (FLAT_WARP) on
    the same crop and on the whole headline launch's counts frame_cnt."""
    cfg = HEADLINE
    packed, cam = packed_inputs("large", cfg)
    x0, y0, w, h = OCC_CROP
    yy, xx = torch.meshgrid(torch.arange(y0, y0 + h, device="cuda"),
                            torch.arange(x0, x0 + w, device="cuda"),
                            indexing="ij")
    pid = (yy * cfg.width + xx).reshape(-1).to(torch.int32)
    x, y = xx.reshape(-1).float(), yy.reshape(-1).float()
    t0 = time.perf_counter()
    per = torch.stack([megakernel.trace_respawn_reference(
        packed, cam, pid, x, y, cfg, (s, s + 1))[1].reshape(h, w)
        for s in range(cfg.spp)])
    secs = time.perf_counter() - t0
    occ = {"nested_crop": warp_occupancy(per, NESTED_WARP),
           "nested_crop_8x4": warp_occupancy(per, FLAT_WARP),
           "flat_crop": warp_occupancy(per.sum(0, keepdim=True), FLAT_WARP),
           "flat_frame": warp_occupancy(
               frame_cnt.reshape(1, cfg.height, cfg.width), FLAT_WARP)}
    print(f"[occupancy] headline crop {w}x{h} at ({x0}, {y0}), "
          f"{cfg.spp} samples one at a time through the plain version "
          f"({secs:.1f} s), {int(per.sum())} segments: loop nest on "
          f"{NESTED_WARP[0]}x{NESTED_WARP[1]} warps "
          f"{occ['nested_crop']:.4f} (on {FLAT_WARP[0]}x{FLAT_WARP[1]} "
          f"{occ['nested_crop_8x4']:.4f}); flat loop on "
          f"{FLAT_WARP[0]}x{FLAT_WARP[1]} warps {occ['flat_crop']:.4f}; "
          f"flat loop over the whole headline launch "
          f"{occ['flat_frame']:.4f}", flush=True)
    return occ


def max_gap(k, p):
    """Max abs difference over pairs of tensors (bool and int as float)."""
    return max(float((a.double() - b.double()).abs().max()) if a.numel()
               else 0.0 for a, b in zip(k, p))


def index_gap(label, k, p):
    """k, p: (idx, hit) of kernel and plain version; raise unless equal bit
    for bit; returns (hits, max abs gap)."""
    n_idx = int((k[0] != p[0]).sum())
    n_hit = int((k[1] != p[1]).sum())
    if n_idx or n_hit:
        raise AssertionError(f"{label}: index kernel vs plain version: "
                             f"{n_idx} indices and {n_hit} hit flags differ")
    return int(k[1].sum()), max_gap(k, p)


def device_ms(fn, function, reps):
    """torch.profiler over reps calls of fn: (device ms a call of the
    port's __global__ `function`, device ms a call of every device event,
    names of the device events that are not `function`)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no device event")
    dur = lambda e: (e.time_range.end - e.time_range.start) / 1e3
    mine = [e for e in dev if bench_grad.is_kernel(e.name, function)]
    return (sum(map(dur, mine)) / reps, sum(map(dur, dev)) / reps,
            sorted({e.name[:60] for e in dev if e not in mine}))


def index_split(label, fn, call_ms, reps):
    """Print the index kernel's profiler device time a call beside the
    call's CUDA-event time; raise if the call ran any other device work."""
    alone, every, others = device_ms(fn, "index_kernel", reps)
    print(f"[index] {label}: the call {call_ms:.4f} ms (CUDA events, "
          f"launch_ms), the kernel alone {alone:.4f} ms, every device event "
          f"of the call {every:.4f} ms (profiler, {reps} calls)", flush=True)
    if others:
        raise AssertionError(f"{label}: closest_hit_index ran other device "
                             f"work: {others}")
    return alone


def index_frame(label, scene_name, pad, rows=None):
    """The index kernel on every primary ray of a 1280x720 @ 4 spp frame
    (one launch) against its plain version in chunks of INDEX_PLAIN_CHUNK,
    on the scene's first `rows` rows if given; returns (prepared spheres,
    rays, max abs gap, kernel ms, profiler device ms of the kernel)."""
    cfg = RenderConfig(**FULL)
    _, prep, rays, _ = grad_inputs(scene_name, cfg, pad)
    if rows:
        prep = dataclasses.replace(prep, **{
            f.name: getattr(prep, f.name)[:rows].contiguous()
            for f in dataclasses.fields(prep)})
    fn = lambda: intersect_index.closest_hit_index(prep, *rays, cfg.t_min)
    fn()
    k, k_ms, _, _ = launch_ms(fn)
    table = intersect_index.pack(prep)
    parts, p_ms = cuda_ms(lambda: [
        intersect_index.closest_hit_index_reference(
            table, *(r[lo:lo + INDEX_PLAIN_CHUNK] for r in rays), cfg.t_min)
        for lo in range(0, rays[0].numel(), INDEX_PLAIN_CHUNK)])
    p = tuple(torch.cat([q[c] for q in parts]) for c in range(2))
    hits, err = index_gap(label, k, p)
    bound = index_bound(rays[0].numel(), prep.count)
    print(f"[index] {label} ({prep.count} rows), {rays[0].numel()} primary "
          f"rays: idx and hit equal, {hits} hits | kernel {k_ms:.3f} ms "
          f"(one launch), plain {p_ms:.1f} ms (chunks of "
          f"{INDEX_PLAIN_CHUNK}); bound {bound[0]:.4f} ms ({bound[1]})",
          flush=True)
    alone = index_split(label, fn, k_ms, 3)
    return prep, rays, err, k_ms, alone


def index_random(label, prep, n, seed):
    """Seeded random rays, every 50th direction zero, kernel against plain
    version; returns the max abs gap."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    o = (torch.rand((3, n), generator=g, device="cuda") * 2 - 1) * 6
    o[1] = o[1].abs() + 0.2
    d = torch.randn((3, n), generator=g, device="cuda")
    d = d / d.norm(dim=0)
    d[:, ::50] = 0.0
    k = intersect_index.closest_hit_index(prep, *o, *d, 1e-3)
    p = intersect_index.closest_hit_index_reference(intersect_index.pack(prep),
                                                    *o, *d, 1e-3)
    hits, err = index_gap(label, k, p)
    print(f"[index] {label}: {n} random rays ({prep.count} rows), idx and "
          f"hit equal, {hits} hits", flush=True)
    return err


def index_checks():
    """The index kernel against its plain version on the medium and giant
    frames and on random rays; returns (max abs gap, and ms, plain ms and
    bound of one launch at the medium fit's chunk shape)."""
    prep, rays, err, _, _ = index_frame("medium 1280x720 @ 4 spp", "medium",
                                        8)
    chunk = [r[:INDEX_CHUNK].contiguous() for r in rays]
    fn = lambda: intersect_index.closest_hit_index(prep, *chunk, 1e-3)
    fn()
    k, k_ms, _, _ = launch_ms(fn)
    table = intersect_index.pack(prep)
    p, p_ms = cuda_ms(lambda: intersect_index.closest_hit_index_reference(
        table, *chunk, 1e-3))
    errs = [err, index_gap("medium chunk", k, p)[1]]
    bound = index_bound(INDEX_CHUNK, prep.count)
    print(f"[index] medium, one chunk of {INDEX_CHUNK} rays x {prep.count} "
          f"rows: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]})", flush=True)
    index_split(f"medium, one chunk of {INDEX_CHUNK} rays", fn, k_ms, 50)
    errs.append(index_random("medium", prep, 777, 1))
    giant, _, err, _, _ = index_frame("giant 1280x720 @ 4 spp", "giant", 8)
    errs += [err, index_random("giant", giant, 777, 2),
             index_random("giant", giant, 100_000, 3)]
    # A whole tile of the kernel's shared memory and a ragged one.
    errs.append(index_frame("giant 1280x720 @ 4 spp, its first 1,500 rows",
                            "giant", 8, rows=1500)[2])
    return max(errs), k_ms, p_ms, bound


def phase_gap(label, k, p):
    """k, p: tuples of tensors; raise unless each pair is equal bit for
    bit; returns the max abs gap."""
    n_diff = sum(int((a != b).sum()) for a, b in zip(k, p))
    if n_diff:
        raise AssertionError(f"{label}: phase kernel vs plain version: "
                             f"{n_diff} values differ")
    return max_gap(k, p)


def phase_case(label, scene_name, w, h, spp, mb, schedules):
    """Each phase from the same state, kernel against plain version, then
    the whole wavefront trace against trace_wavefront_reference; returns
    the max abs gap."""
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb)
    packed, _ = packed_inputs(scene_name, cfg)
    ray_id, x, y = ray_coords(cfg, "cuda")
    camera = builders.SCENES[scene_name](cfg.aspect,
                                         device="cuda").camera.build("cuda")
    rays = [r.contiguous() for r in primary_rays(camera, cfg, x, y, ray_id)]
    errs = []
    for schedule in schedules:
        state, alive, cnt = megakernel.wavefront_state(*rays, ray_id, cfg)
        spans = megakernel.wavefront_spans(schedule, mb)
        for k, (b0, bend) in enumerate(spans):
            slots = alive.nonzero()[:, 0].to(torch.int32) if k else None
            ref = [t.clone() for t in (state, alive, cnt)]
            megakernel.wavefront_phase_reference(packed, ref[0], ref[1],
                                                 ray_id, ref[2], slots, b0,
                                                 bend, cfg)
            megakernel.wavefront_phase(packed, state, alive, ray_id, cnt,
                                       slots, b0, bend, cfg)
            errs.append(phase_gap(f"{label} {schedule} phase {k}",
                                  (state, alive, cnt), ref))
        k_rad, k_cnt, k_total = megakernel.trace_wavefront(
            packed, *rays, ray_id, cfg, schedule)
        p_rad, p_cnt, p_total = megakernel.trace_wavefront_reference(
            packed, *rays, ray_id, cfg, schedule)
        errs.append(phase_gap(f"{label} {schedule} trace", (*k_rad, k_cnt),
                              (*p_rad, p_cnt)))
        if int(k_total) != int(p_total):
            raise AssertionError(f"{label} {schedule}: ray totals differ")
        print(f"[phase] {label}, schedule {schedule} (spans {spans}): every "
              f"phase's state, alive flags and counts equal; trace radiance "
              f"and counts equal, {int(k_total)} rays", flush=True)
    return max(errs)


def engine_inputs(scene, camera, cfg):
    """The packed table, primary rays and ray ids render_image_megakernel
    gives the one-shot and wavefront kernels."""
    packed = megakernel.pack_spheres(prepare_trimmed(scene.spheres,
                                                     scene.n_real))
    ray_id, x, y = ray_coords(cfg, "cuda")
    rays = [r.contiguous() for r in primary_rays(camera, cfg, x, y, ray_id)]
    return packed, rays, ray_id


def oneshot_vs_plain(label, packed, rays, ray_id, cfg, frame, n_frame):
    """The one-shot kernel (no topology) on the engine's frame inputs, which
    must reproduce the engine's image and ray count, against its plain
    version over the whole frame in chunks of PLAIN_CHUNK rays: per-ray
    radiance and counts equal bit for bit. Then the lane occupancy a
    thread-per-ray loop nest would have on this frame, from the kernel's own
    per-ray counts, on warps of 32 consecutive rays, beside the flat loop's
    time; and the frame's rays in a seeded order (REFILL_SEED), whose
    outputs must be the frame's, ray for ray. Returns (max abs gap, kernel
    ms, plain ms)."""
    (k_rad, k_cnt, k_total), k_ms = cuda_ms(
        lambda: megakernel.trace_oneshot(packed, *rays, ray_id, cfg))
    if not (torch.equal(image_of_rays(*k_rad, cfg), frame)
            and int(k_total) == n_frame):
        raise AssertionError(f"{label}: the comparison launch does not "
                             f"reproduce the one-shot engine's frame")
    parts, p_ms = cuda_ms(lambda: plain_chunked(
        lambda *t: megakernel.trace_topology_reference(packed, *t, cfg)[:2],
        ray_id.numel(), *rays, ray_id))
    p_rad = [torch.cat([q[0][c] for q in parts]) for c in range(3)]
    p_cnt = torch.cat([q[1] for q in parts])
    n_diff = sum(int((a != b).sum()) for a, b in zip((*k_rad, k_cnt),
                                                      (*p_rad, p_cnt)))
    if n_diff:
        raise AssertionError(f"{label}: one-shot kernel vs plain version: "
                             f"{n_diff} radiance values and counts differ")
    print(f"[engines] {label}: one-shot kernel (no topology) on the frame's "
          f"{ray_id.numel()} rays {k_ms:.2f} ms, plain version {p_ms:.1f} ms "
          f"(chunks of {PLAIN_CHUNK}): radiance and counts equal",
          flush=True)
    nest = warp_occupancy(k_cnt.reshape(1, 1, -1), (32, 1))
    print(f"[occupancy] {label}: a thread-per-ray loop nest on warps of 32 "
          f"consecutive rays would keep {nest:.4f} of its lanes busy (from "
          f"the kernel's per-ray counts: {n_frame} segments, mean "
          f"{n_frame / ray_id.numel():.3f}, max {int(k_cnt.max())}); the flat "
          f"loop took {k_ms:.2f} ms", flush=True)
    perm = torch.randperm(ray_id.numel(), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(
                              REFILL_SEED))
    q_rad, q_cnt, q_total = megakernel.trace_oneshot(
        packed, *(r[perm].contiguous() for r in rays),
        ray_id[perm].contiguous(), cfg)
    n_diff = sum(int((a != b[perm]).sum()) for a, b in zip(
        (*q_rad, q_cnt), (*k_rad, k_cnt)))
    if n_diff or int(q_total) != n_frame:
        raise AssertionError(f"{label}: the frame's rays in another order: "
                             f"{n_diff} radiance values and counts differ")
    print(f"[engines] {label}: the frame's rays in a seeded order: every "
          f"ray's radiance and count equal to the in-order launch's",
          flush=True)

    # The kIters instantiation: the same outputs; from 16 rows up (the flat
    # loop) its trips depend on the refill order and are held to bounds.
    i_rad, i_cnt, i_total, i_iters = megakernel.trace_oneshot(
        packed, *rays, ray_id, cfg, debug_iters=True)
    n_diff = sum(int((a != b).sum()) for a, b in zip((*i_rad, i_cnt),
                                                      (*p_rad, p_cnt)))
    if n_diff or int(i_total) != n_frame:
        raise AssertionError(f"{label}: kIters one-shot kernel vs plain "
                             f"version: {n_diff} values differ")
    low, t_ms = cuda_ms(lambda: megakernel.oneshot_iters_reference(
        p_cnt, packed.shape[1]))
    check_oneshot_trips(label, int(i_iters), int(low), n_frame)
    off, on = iters_cost(
        f"one-shot, {label}",
        lambda: megakernel.trace_oneshot(packed, *rays, ray_id, cfg),
        lambda: megakernel.trace_oneshot(packed, *rays, ray_id, cfg,
                                         debug_iters=True),
        lambda out: check_oneshot_trips(label, int(out[3]), int(low),
                                        n_frame))
    err = max_gap((*k_rad, k_cnt), (*p_rad, p_cnt))
    # 6 ray planes and ids in, radiance and counts out, and the trip total.
    bound = bound_ms(4 * (7 * packed.shape[1] + ray_id.numel() * 11) + 8,
                     n_frame * packed.shape[1] * SWEEP_OPS)
    return (err, k_ms, p_ms,
            (max_gap((*i_rad, i_cnt), (*p_rad, p_cnt)), on, p_ms + t_ms,
             bound), (off, on))


def check_oneshot_trips(label, trips, low, segments):
    """The flat loop's trips against their bounds: no fewer than the plain
    version's fewest (oneshot_iters_reference), 32 x trips >= the segments
    traced; prints the lane occupancy segments / (32 x trips)."""
    occ = segments / (32 * trips)
    print(f"[iters] {label}: one-shot warp trips {trips}, the fewest any "
          f"refill order takes {low}; lane occupancy {occ:.4f} (bench."
          f"variants' `rounds` variant measured 0.982-0.986 on this frame)",
          flush=True)
    if trips < low or not occ <= 1.0:
        raise AssertionError(f"{label}: one-shot trips {trips} outside "
                             f"their bounds ({low}, {segments} segments)")


def phases_vs_plain(label, packed, rays, ray_id, cfg, frame, n_frame):
    """The wavefront engine's frame again through megakernel._wavefront,
    each phase from the same pre-phase state twice: the kernel between a
    pair of CUDA events, and its plain version on a copy, over the same
    listed rays in chunks of PLAIN_CHUNK. State, alive flags and counts
    equal bit for bit after every phase, and the result must be the
    engine's frame. Returns (max abs gap, kernel ms, plain ms, bound), ms
    summed over the phases."""
    ms, plain_ms, listed, errs = [], [], [], []

    def phase(packed, state, alive, ray_id, cnt, slots, b0, bend, cfg):
        ref = [t.clone() for t in (state, alive, cnt)]
        todo = (torch.arange(ray_id.numel(), dtype=torch.int32,
                             device=ray_id.device) if slots is None
                else slots)
        _, p_ms = cuda_ms(lambda: [
            megakernel.wavefront_phase_reference(
                packed, ref[0], ref[1], ray_id, ref[2],
                todo[lo:lo + PLAIN_CHUNK], b0, bend, cfg)
            for lo in range(0, todo.numel(), PLAIN_CHUNK)])
        _, k_ms = cuda_ms(lambda: megakernel.wavefront_phase(
            packed, state, alive, ray_id, cnt, slots, b0, bend, cfg))
        errs.append(phase_gap(f"{label} phase [{b0}, {bend})",
                              (state, alive, cnt), ref))
        ms.append(k_ms)
        plain_ms.append(p_ms)
        listed.append(todo.numel())

    rad, _, total = megakernel._wavefront(phase, packed, *rays, ray_id, cfg,
                                          WAVEFRONT)
    if not (torch.equal(image_of_rays(*rad, cfg), frame)
            and int(total) == n_frame):
        raise AssertionError(f"{label}: the checked phases do not reproduce "
                             f"the wavefront engine's frame")
    bound = phase_bound(packed.shape[1], len(ms), sum(listed), n_frame)
    spans = megakernel.wavefront_spans(WAVEFRONT, cfg.max_bounces)
    print(f"[engines] {label}: phase kernel, spans {spans}, rays listed "
          f"{listed}: phases {', '.join(f'{t:.3f}' for t in ms)} ms = "
          f"{sum(ms):.3f} ms; plain version "
          f"{', '.join(f'{t:.1f}' for t in plain_ms)} ms = "
          f"{sum(plain_ms):.1f} ms (chunks of {PLAIN_CHUNK}); every phase's "
          f"state, alive flags and counts equal; bound {bound[0]:.4f} ms "
          f"({bound[1]})", flush=True)
    for (b0, bend), m, t in zip(spans, listed, ms):
        print(f"[engines] {label}: phase [{b0}, {bend}): {m} rays listed, "
              f"{t:.3f} ms", flush=True)
    return max(errs), sum(ms), sum(plain_ms), bound


def phases_in_seeded_order(label, packed, rays, ray_id, cfg):
    """The wavefront frame with each phase's list in a seeded order
    (REFILL_SEED): the lanes take the rays in another order, and each ray's
    radiance and count must equal the in-order run's."""
    gen = torch.Generator(ray_id.device).manual_seed(REFILL_SEED)

    def phase(packed, state, alive, ray_id, cnt, slots, b0, bend, cfg):
        todo = (torch.arange(ray_id.numel(), dtype=torch.int32,
                             device=ray_id.device) if slots is None
                else slots)
        perm = torch.randperm(todo.numel(), device=todo.device, generator=gen)
        megakernel.wavefront_phase(packed, state, alive, ray_id, cnt,
                                   todo[perm].contiguous(), b0, bend, cfg)

    q_rad, q_cnt, q_total = megakernel._wavefront(phase, packed, *rays,
                                                  ray_id, cfg, WAVEFRONT)
    k_rad, k_cnt, k_total = megakernel.trace_wavefront(packed, *rays, ray_id,
                                                       cfg, WAVEFRONT)
    n_diff = sum(int((a != b).sum()) for a, b in zip((*q_rad, q_cnt),
                                                      (*k_rad, k_cnt)))
    if n_diff or int(q_total) != int(k_total):
        raise AssertionError(f"{label}: the phases' lists in another order: "
                             f"{n_diff} radiance values and counts differ")
    print(f"[engines] {label}: the wavefront frame with each phase's list in "
          f"a seeded order: every ray's radiance and count equal to the "
          f"in-order run's", flush=True)


def engines_full():
    """The one-shot and wavefront engines at the CLI's full config on the
    large scene, then both kernels against their plain versions on the
    frames' own inputs; returns (one-shot launches, phase launches, one-shot
    max abs gap, phase (max abs gap, ms, plain ms, bound), the one-shot
    kIters entry (max abs gap, ms, plain ms, bound), its (off, on) ms, and
    the three engines' (frame, rays))."""
    cfg = get_config("full")
    scene = builders.SCENES["large"](cfg.aspect, device="cuda")
    camera = scene.camera.build("cuda")
    render = lambda **kw: render_image_megakernel(
        scene.spheres, camera, cfg, n_real=scene.n_real, **kw)
    resp, n_resp = render()
    render(respawn=False)
    render(respawn=False, wavefront=WAVEFRONT)  # warm
    torch.cuda.synchronize()
    reset_launches()
    (one, n_one), one_ms = cuda_ms(lambda: render(respawn=False))
    (wave, n_wave), wave_ms = cuda_ms(
        lambda: render(respawn=False, wavefront=WAVEFRONT))
    launches = (megakernel.ONESHOT_LAUNCHES, megakernel.PHASE_LAUNCHES)
    _, resp_ms = cuda_ms(render)
    n_one, n_wave, n_resp = int(n_one), int(n_wave), int(n_resp)
    label = (f"large {cfg.width}x{cfg.height} @ {cfg.spp} spp @ "
             f"{cfg.max_bounces} b")
    gap = float((one - resp).abs().max())
    print(f"[engines] {label}, {cfg.num_primary_rays} primary rays: "
          f"one-shot {one_ms:.2f} ms ({n_one} rays), wavefront {WAVEFRONT} "
          f"{wave_ms:.2f} ms ({n_wave} rays), respawn {resp_ms:.2f} ms "
          f"({n_resp} rays), whole frames between CUDA events; launches "
          f"one-shot {launches[0]}, phase {launches[1]}; one-shot vs respawn "
          f"image max abs gap {gap:.3e}", flush=True)
    if launches != (1, len(megakernel.wavefront_spans(WAVEFRONT,
                                                      cfg.max_bounces))):
        raise AssertionError(f"{label}: engine launches {launches}")
    if not (torch.equal(wave, one) and n_wave == n_one):
        raise AssertionError(f"{label}: the wavefront engine differs from "
                             f"the one-shot engine")
    if n_one != n_resp or not gap <= SPLIT_TOL:
        raise AssertionError(f"{label}: one-shot vs respawn: rays {n_one} "
                             f"vs {n_resp}, image gap {gap}")
    if not torch.isfinite(one).all():
        raise AssertionError(f"{label}: non-finite pixels")

    packed, rays, ray_id = engine_inputs(scene, camera, cfg)
    one_err, k_ms, _, one_iters, one_cost = oneshot_vs_plain(
        label, packed, rays, ray_id, cfg, one, n_one)
    # 6 ray planes and ids in, radiance and counts out, no topology.
    bound = bound_ms(4 * (7 * packed.shape[1] + ray_id.numel() * 11),
                     n_one * packed.shape[1] * SWEEP_OPS)
    print(f"[engines] one-shot bound {bound[0]:.3f} ms ({bound[1]}), "
          f"{bound[0] / k_ms:.3f} of its kernel's time, "
          f"{bound[0] / one_ms:.3f} of its frame's", flush=True)
    phase = phases_vs_plain(label, packed, rays, ray_id, cfg, wave, n_wave)
    print(f"[engines] {label}: wavefront frame less its phases "
          f"{wave_ms - phase[1]:.3f} ms, one-shot frame less its kernel "
          f"{one_ms - k_ms:.3f} ms: the listings between phases take about "
          f"{(wave_ms - phase[1]) - (one_ms - k_ms):.3f} ms", flush=True)
    phases_in_seeded_order(label, packed, rays, ray_id, cfg)
    frames = {"oneshot": (one, n_one), "wavefront": (wave, n_wave),
              "respawn": (resp, n_resp)}
    return launches + (one_err, phase, one_iters, one_cost, frames)


def shard_local(frames):
    """The kernel engines' local functions (parallel/shard.kernel_local),
    every coordinate of SHARD_SHAPES in turn on the one card, at the CLI
    full config on the large scene, against the single-device frames of
    engines_full (frames: engine -> (image, rays)): one-shot and wavefront
    images equal bit for bit; respawn equal on the tile mesh and within
    SPLIT_TOL on 2x2 (each pixel's two sample spans added once, as
    compare_case's split); the ranks' rays summing to the frame's; the
    respawn kernel's trips equal to the plain twin of each rank's per-pixel
    counts; the one-shot kernel's inside their bounds."""
    cfg = get_config("full")
    scene = builders.SCENES["large"](cfg.aspect, device="cuda")
    camera = scene.camera.build("cuda")
    s_count = prepare_trimmed(scene.spheres, scene.n_real).count
    for shape in SHARD_SHAPES:
        coords = [(i, j) for i in range(shape[0]) for j in range(shape[1])]
        for engine, kw in (("oneshot", {}),
                           ("wavefront", dict(wavefront=WAVEFRONT)),
                           ("respawn", dict(respawn=True))):
            label = (f"{engine}, {shape[0]}x{shape[1]} (tiles, samples), "
                     f"large {cfg.width}x{cfg.height} @ {cfg.spp} spp @ "
                     f"{cfg.max_bounces} b")
            telemetry = engine != "wavefront"
            parts = [shard.kernel_local(scene.spheres, camera, cfg, shape, c,
                                        n_real=scene.n_real,
                                        telemetry=telemetry, **kw)
                     for c in coords]
            assemble = (shard.assemble_pixels if engine == "respawn"
                        else shard.assemble_rays)
            img = assemble(torch.stack([p.rad for p in parts]), cfg, shape)
            want, n_want = frames[engine]
            rays = [int(p.rays) for p in parts]
            gap = float((img - want).abs().max())
            exact = engine != "respawn" or shape[1] == 1
            if sum(rays) != n_want or not gap <= SPLIT_TOL or (
                    exact and not torch.equal(img, want)):
                raise AssertionError(f"[shard] {label}: rays {sum(rays)} "
                                     f"against {n_want}, image gap {gap}")
            line = (f"[shard] {label}: image "
                    + ("equal bit for bit" if torch.equal(img, want) else
                       f"within {gap:.3e}")
                    + f" to the single-device frame; rays per rank {rays}")
            if engine == "respawn":
                iters = [int(p.iters) for p in parts]
                twins = [int(megakernel.respawn_iters_reference(
                    p.cnt, cfg.width)) for p in parts]
                if iters != twins:
                    raise AssertionError(f"[shard] {label}: trips {iters} "
                                         f"against the plain twin's {twins}")
                line += f"; warp trips {iters} = the plain twin's"
            elif engine == "oneshot":
                iters = [int(p.iters) for p in parts]
                lows = [int(megakernel.oneshot_iters_reference(p.cnt,
                                                               s_count))
                        for p in parts]
                occ = [r / (32 * t) for r, t in zip(rays, iters)]
                if any(t < lo for t, lo in zip(iters, lows)) or \
                        max(occ) > 1.0:
                    raise AssertionError(f"[shard] {label}: trips {iters} "
                                         f"outside their bounds {lows}")
                line += (f"; warp trips {iters} (fewest possible {lows}), "
                         f"lane occupancy "
                         f"{', '.join(f'{o:.4f}' for o in occ)}")
            print(line, flush=True)


def shard_gradient():
    """The sharded fused gradient's local functions on the medium fit frame
    (FULL, medium, 48 rows), a 4-way mesh: kernel A on each rank's ray
    slice (grad.mega.shard_forward) equal bit for bit to the single-device
    launch at those rays (padding ids: count 0, topology -1), kernel B on
    each slice with its rays' cotangents: ray cotangents equal to the
    single-device B's, the ranks' (10, S) columns summed within GRAD_TOL of
    the single-device B's under the summed-scale rule (gradient_gap, each
    rank's sums a chunk). Returns the worst relative gap."""
    cfg = RenderConfig(**FULL)
    scene, prep, rays, ray_id = grad_inputs("medium", cfg, 8)
    camera = scene.camera.build("cuda")
    packed = megakernel.pack_spheres(prep)
    n = ray_id.numel()
    rad, cnt, _, topo = megakernel.trace_topology(packed, *rays, ray_id, cfg)
    cts = random_cts(n, 3)
    grads, ray_cts = mega_backward.backward(prep, *rays, ray_id, *cts, topo,
                                            cfg)
    label = (f"sharded fused gradient, 4 ranks, medium ({prep.count} rows) "
             f"{cfg.width}x{cfg.height} @ {cfg.spp} spp @ "
             f"{cfg.max_bounces} b")
    parts = []
    for d in range(4):
        ids = shard.ray_slice(cfg, 4, 1, d, 0, "cuda")
        real = ids < n
        idx = ids.clamp_max(n - 1).long()
        ((r_rad, r_cnt, _, r_topo), r_rays) = mega.shard_forward(
            prep, camera, cfg, ids)
        same = (all(torch.equal(a[real], b[idx[real]])
                    for a, b in zip((*r_rad, r_cnt, *r_rays),
                                    (*rad, cnt, *rays)))
                and torch.equal(r_topo[:, real], topo[:, idx[real]])
                and int(r_cnt[~real].abs().sum()) == 0
                and bool((r_topo[:, ~real] == -1).all()))
        if not same:
            raise AssertionError(f"[shard] {label}: rank {d}'s kernel A "
                                 f"differs from the single-device launch")
        r_cts = [torch.where(real, c[idx], 0.0) for c in cts]
        g, rc = mega_backward.backward(prep, *r_rays, ids, *r_cts, r_topo,
                                       cfg)
        if not all(torch.equal(a[real], b[idx[real]])
                   for a, b in zip(rc, ray_cts)):
            raise AssertionError(f"[shard] {label}: rank {d}'s ray "
                                 f"cotangents differ")
        parts.append(g)
    rel, err = gradient_gap(label, (sum(parts), ray_cts), (grads, ray_cts),
                            scene.spheres, scene.n_real,
                            ("medium", scene.spheres, cfg, cts, 3, None),
                            parts)
    print(f"[shard] {label}: kernel A on each rank's slice equal to the "
          f"single-device launch; ray cotangents equal; (10, S) sum over "
          f"the ranks within {rel:.2e} of the single-device B (GRAD_TOL "
          f"{GRAD_TOL}, summed scales), max abs gap {err:.2e}", flush=True)
    return rel


def shard_group(head_img, head_rays, frames):
    """The sharded path through a group of one NCCL rank, every launch
    counted from 0: render_image_pallas_sharded at the CLI full config on
    the large scene for each engine (one-shot and respawn with telemetry,
    wavefront, and the one-shot engine on a 1x1 (tiles, samples) mesh),
    each image and count equal to engines_full's single-device frame
    (frames) bit for bit; the headline through respawn=True, equal to the
    main path's frame (head_img, head_rays); one fit_scene(mesh=...) step
    on the medium fit recipe on each engine ("mega", the sharded fused
    path; "pipeline", the sharded plain render with the index kernel),
    each loss within GRAD_TOL of the unsharded step's. Returns the
    launches of each kernel."""
    cfg = get_config("full")
    scene = builders.SCENES["large"](cfg.aspect, device="cuda")
    camera = scene.camera.build("cuda")
    fit_cfg = RenderConfig(**FULL)
    medium = builders.SCENES["medium"](fit_cfg.aspect, pad_multiple=8,
                                       device="cuda")
    m_camera = medium.camera.build("cuda")
    start = perturb_albedos(medium.spheres, medium.n_real)
    inv = InverseConfig(learning_rate=1e-2, steps=1, optimize=ALBEDOS)
    targets, unsharded = {}, {}
    for engine in ("mega", "pipeline"):
        with torch.no_grad():
            targets[engine] = render_for_loss(medium.spheres, m_camera,
                                              fit_cfg, engine=engine)
        unsharded[engine] = fit_scene(start, m_camera, targets[engine],
                                      fit_cfg, inv, engine=engine)[1][0]

    store = tempfile.mkdtemp(prefix="rays1bench_group_")
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for engine, kw in (("oneshot", dict(telemetry=True)),
                           ("respawn", dict(respawn=True, telemetry=True)),
                           ("wavefront", dict(wavefront=WAVEFRONT))):
            out = render_image_pallas_sharded(scene.spheres, camera, cfg,
                                              mesh, n_real=scene.n_real,
                                              **kw)
            want, n_want = frames[engine]
            if not (torch.equal(out[0], want) and int(out[1]) == n_want):
                raise AssertionError(f"[shard] group of one, {engine}: the "
                                     f"frame differs from the single-device "
                                     f"one")
            telem = (f"; device_rays {out[2]['device_rays'].tolist()}, "
                     f"device_iters {out[2]['device_iters'].tolist()}"
                     if len(out) == 3 else "")
            print(f"[shard] group of one NCCL rank, {engine}, large "
                  f"{cfg.width}x{cfg.height} @ {cfg.spp} spp @ "
                  f"{cfg.max_bounces} b: image and rays ({int(out[1])}) "
                  f"equal to the single-device frame's{telem}", flush=True)
        img, n = render_image_pallas_sharded(
            scene.spheres, camera, cfg, make_mesh2d(1, 1), axis_name="tiles",
            sample_axis="samples", n_real=scene.n_real)
        if not (torch.equal(img, frames["oneshot"][0])
                and int(n) == frames["oneshot"][1]):
            raise AssertionError("[shard] group of one, 1x1 mesh: the "
                                 "frame differs")
        img, n = render_image_pallas_sharded(scene.spheres, camera, HEADLINE,
                                             mesh, n_real=scene.n_real,
                                             respawn=True)
        if not (torch.equal(img, head_img) and int(n) == head_rays):
            raise AssertionError("[shard] group of one: the headline differs "
                                 "from the main path's frame")
        print(f"[shard] group of one NCCL rank: the 1x1 (tiles, samples) "
              f"mesh's one-shot frame and the headline through respawn=True "
              f"({int(n)} rays) equal to the single-device frames",
              flush=True)
        for engine in ("mega", "pipeline"):
            losses = fit_scene(start, m_camera, targets[engine], fit_cfg,
                               inv, mesh=mesh, engine=engine)[1]
            gap = abs(losses[0] - unsharded[engine]) / abs(unsharded[engine])
            print(f"[shard] group of one NCCL rank: fit_scene(mesh=...) step "
                  f"on the medium fit recipe, engine {engine}: loss "
                  f"{losses[0]:.6e}, unsharded {unsharded[engine]:.6e} "
                  f"(relative gap {gap:.2e})", flush=True)
            if not gap <= GRAD_TOL:
                raise AssertionError(f"[shard] {engine} step loss differs")
        torch.cuda.synchronize()
        launches = {
            "respawn": megakernel.LAUNCHES,
            "oneshot": megakernel.ONESHOT_LAUNCHES,
            "phase": megakernel.PHASE_LAUNCHES,
            "respawn_iters": megakernel.RESPAWN_ITERS_LAUNCHES,
            "oneshot_iters": megakernel.ONESHOT_ITERS_LAUNCHES,
            "mega_backward": mega_backward.LAUNCHES,
            "intersect_index": intersect_index.LAUNCHES}
        print(f"[shard] group of one NCCL rank: the path in "
              f"{time.perf_counter() - t0:.1f} s; launches {launches}",
              flush=True)
        missing = [k for k, v in launches.items() if v < 1]
        if missing:
            raise AssertionError(f"[shard] the sharded path launched no "
                                 f"{missing}")
        return launches
    finally:
        torch.distributed.destroy_process_group()


def parse_record(text):
    """(version, seconds, rays, mrays/s) of one out_<scene>.txt record."""
    version, secs, rays, mrays, tail = text.split("|")
    if tail or not secs.endswith("s") or not mrays.endswith(" mrays/s"):
        raise AssertionError(f"malformed record {text!r}")
    return version, float(secs[:-1]), int(rays), float(mrays[:-8])


def cli_run():
    """The multi-scene CLI at its defaults; returns its one-shot launches."""
    out_dir = tempfile.mkdtemp(prefix="rays1bench_cli_")
    reset_launches()
    cli.main(["--scenes", "small,medium,large", "--num", "1", "--out-dir",
              out_dir])
    launches = megakernel.ONESHOT_LAUNCHES
    for name in ("small", "medium", "large"):
        with open(os.path.join(out_dir, f"out_{name}.txt")) as f:
            version, secs, rays, mrays = parse_record(f.read())
        print(f"[cli] out_{name}.txt: {version} | {secs} s | {rays} rays | "
              f"{mrays} mrays/s", flush=True)
        if not (secs > 0 and rays > get_config("full").num_primary_rays
                and mrays > 0):
            raise AssertionError(f"out_{name}.txt: implausible record")
    print(f"[cli] one-shot kernel launches {launches}", flush=True)
    if launches < 3:
        raise AssertionError("the CLI did not run the one-shot kernel")
    return launches


def pipeline_grads(cfg, scene, camera, pallas):
    params = params_of(scene.spheres, ("center_x", "center_y", "radius",
                                       "albedo_x", "albedo_y"))
    img, n = render_image(with_params(scene.spheres, params), camera,
                          cfg.replace(pallas_intersect=pallas))
    torch.mean((img - 0.3) ** 2).backward()
    return [img, n] + [p.grad for p in params.values()]


def pipeline_index_vs_sweep():
    """engine="pipeline" with the index kernel and with the plain sweep:
    image, rays and gradients equal bit for bit."""
    cfg = RenderConfig(width=160, height=90, spp=4, max_bounces=10,
                       seed=FIT_SEED, early_exit=False)
    scene = builders.SCENES["medium"](cfg.aspect, pad_multiple=8,
                                      device="cuda")
    camera = scene.camera.build("cuda")
    before = intersect_index.LAUNCHES
    k = pipeline_grads(cfg, scene, camera, True)
    launches = intersect_index.LAUNCHES - before
    p = pipeline_grads(cfg, scene, camera, False)
    n_diff = sum(int((a != b).sum()) for a, b in zip(k, p))
    print(f"[pipeline] medium 160x90 @ 4 spp @ 10 b: index kernel ({launches} "
          f"launches) vs plain sweep: {n_diff} values differ in image, rays "
          f"and gradients", flush=True)
    if n_diff or launches != cfg.max_bounces + 1:
        raise AssertionError("pipeline gradients differ with the index "
                             "kernel")


def peak_step_gib(scene, camera, cfg, target, remat):
    """Peak device memory of one forward and backward of the pipeline loss
    (GiB), and the index kernel's launches in the backward."""
    params = params_of(perturb_albedos(scene.spheres, scene.n_real), ALBEDOS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    img, _ = render_image(with_params(scene.spheres, params), camera,
                          inverse._grad_cfg(cfg), remat=remat)
    loss = torch.mean((img - target) ** 2)
    before = intersect_index.LAUNCHES
    loss.backward()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() / 2**30,
            intersect_index.LAUNCHES - before)


@contextlib.contextmanager
def recorded_index_calls(count):
    """Inside the block, the first `count` calls of
    intersect_index.closest_hit_index keep a copy of their table, ray
    planes, t_min and result; the calls themselves are unchanged. Yields
    the list of (table, rays, t_min, (idx, hit))."""
    calls, launch = [], intersect_index.closest_hit_index

    def record(prep, ox, oy, oz, dx, dy, dz, t_min):
        rays = (ox, oy, oz, dx, dy, dz)
        out = launch(prep, *rays, t_min)
        if len(calls) < count:
            calls.append((intersect_index.pack(prep),
                          [r.detach().clone() for r in rays], t_min,
                          tuple(t.clone() for t in out)))
        return out

    intersect_index.closest_hit_index = record
    try:
        yield calls
    finally:
        intersect_index.closest_hit_index = launch


def index_bounces_vs_plain(label, calls):
    """The index kernel's results on the recorded rays of one chunk's
    bounces (0 = primary; later bounces start on sphere surfaces, near
    t_min) against its plain version in chunks of INDEX_PLAIN_CHUNK, bit
    for bit; returns the max abs gap."""
    errs, hits = [], []
    for b, (table, rays, t_min, k) in enumerate(calls):
        n = rays[0].numel()
        parts = [intersect_index.closest_hit_index_reference(
            table, *(r[lo:lo + INDEX_PLAIN_CHUNK] for r in rays), t_min)
            for lo in range(0, n, INDEX_PLAIN_CHUNK)]
        p = tuple(torch.cat([q[c] for q in parts]) for c in range(2))
        h, err = index_gap(f"{label}, bounce {b}", k, p)
        errs.append(err)
        hits.append(h)
    print(f"[pipeline] {label}: index kernel on the first chunk's rays of "
          f"bounces 0-{len(calls) - 1} as the fit gave them "
          f"({calls[0][1][0].numel()} rays each), idx and hit equal to the "
          f"plain version; hits per bounce {hits}", flush=True)
    return max(errs)


def pipeline_fit(scene_name, steps, engine):
    """fit_scene through the pipeline on the medium recipe's workload;
    returns (scene, camera, cfg, target, index launches, max abs gap of
    the index kernel on the fit's first chunk of rays, every bounce)."""
    cfg = RenderConfig(**FULL)
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=8,
                                        device="cuda")
    camera = scene.camera.build("cuda")
    route = inverse._pick_engine(scene.spheres, cfg, engine)
    with torch.no_grad():
        target = render_for_loss(scene.spheres, camera, cfg, engine=engine)
    start = perturb_albedos(scene.spheres, scene.n_real)
    inv = InverseConfig(learning_rate=1e-2, steps=steps, optimize=ALBEDOS)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # The first forward's first chunk calls the index kernel once a bounce.
    with recorded_index_calls(cfg.max_bounces + 1) as calls:
        _, losses = fit_scene(start, camera, target, cfg, inv, engine=engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = intersect_index.LAUNCHES
    chunks = -(-cfg.num_primary_rays // cfg.ray_chunk)
    want = chunks * (cfg.max_bounces + 1) * steps
    label = (f"{scene_name} ({scene.spheres.count} rows) {cfg.width}x"
             f"{cfg.height} @ {cfg.spp} spp @ {cfg.max_bounces} b, "
             f"engine={engine!r} -> {route!r}")
    print(f"[pipeline] {label}: {steps} Adam steps in {wall * 1e3:.1f} ms "
          f"wall ({wall * 1e3 / steps:.1f} ms a step, first-call set-up "
          f"included); losses {', '.join(f'{x:.6e}' for x in losses)}; "
          f"index kernel launches {launches} (expected {chunks} chunks x "
          f"{cfg.max_bounces + 1} bounces x {steps} = {want}); one-shot "
          f"{megakernel.ONESHOT_LAUNCHES}, fused backward "
          f"{mega_backward.LAUNCHES}", flush=True)
    if route != "pipeline":
        raise AssertionError(f"{label}: routed to {route!r}")
    if launches != want or megakernel.ONESHOT_LAUNCHES or \
            mega_backward.LAUNCHES:
        raise AssertionError(f"{label}: launches differ from the pipeline's")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss")
    if steps > 1 and not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall")
    if len(calls) != cfg.max_bounces + 1 or \
            calls[0][1][0].numel() != min(cfg.ray_chunk,
                                          cfg.num_primary_rays):
        raise AssertionError(f"{label}: did not record the first chunk's "
                             f"{cfg.max_bounces + 1} bounces")
    err = index_bounces_vs_plain(label, calls)
    return scene, camera, cfg, target, launches, err


def pipeline_checks():
    """engine="pipeline": the medium fit, a warm step, peak memory with and
    without remat, and the giant step through auto; returns the index
    kernel's launches on those main paths and its max abs gap to its plain
    version on their recorded bounces."""
    scene, camera, cfg, target, medium, m_err = pipeline_fit(
        "medium", 3, "pipeline")
    start = perturb_albedos(scene.spheres, scene.n_real)
    inv = InverseConfig(learning_rate=1e-2, optimize=ALBEDOS)
    step, _ = make_train_step(start, camera, cfg, inv,
                              params_of(start, ALBEDOS), engine="pipeline")
    _, step_ms = cuda_ms(lambda: step(target))
    peak = {remat: peak_step_gib(scene, camera, cfg, target, remat)
            for remat in (True, False)}
    print(f"[pipeline] medium warm step {step_ms:.1f} ms (CUDA events); "
          f"peak device memory of one step: remat {peak[True][0]:.2f} GiB, "
          f"without {peak[False][0]:.2f} GiB; index launches in the "
          f"backward {peak[True][1]} / {peak[False][1]}", flush=True)
    if peak[True][1] or peak[False][1]:
        raise AssertionError("the backward launched the index kernel")
    *_, giant, g_err = pipeline_fit("giant", 1, "auto")
    return medium + giant, max(m_err, g_err)


def camfit_fits(scene, cfg):
    """Each recipe fit of bench.camfit (CASES) on "mega", CAMFIT_STEPS
    steps, in cfg's mode, held to the JAX test's bars. Returns ((topology,
    backward) launches of the fits, the fitted lookfrom's spec, the true
    camera's render)."""
    soft = cfg.soft_silhouette
    with torch.no_grad():
        target = render_for_loss(scene.spheres, scene.camera.build("cuda"),
                                 cfg, engine="mega")
    label = (f"small ({scene.spheres.count} rows) {cfg.width}x{cfg.height} "
             f"@ {cfg.spp} spp @ {cfg.max_bounces} b, seed {cfg.seed}, "
             f"soft {soft}")
    launches, missed, fitted_spec = [0, 0], [], scene.camera
    for leaf in camfit_bench.CASES:
        reset_launches()
        r = camfit_bench.fit(scene, target, cfg, leaf, "mega", CAMFIT_STEPS,
                             "cuda")
        got = (megakernel.ONESHOT_LAUNCHES, mega_backward.LAUNCHES)
        launches = [a + b for a, b in zip(launches, got)]
        losses = r["losses"]
        print(f"[camfit] {label}: {leaf} moved by {r['move']}, lr {r['lr']}:"
              f" {CAMFIT_STEPS} Adam steps in {r['seconds']:.2f} s wall "
              f"({r['seconds'] * 1e3 / CAMFIT_STEPS:.2f} ms a step, "
              f"first-call set-up included); launches topology {got[0]} "
              f"backward {got[1]}; loss {losses[0]:.6e} -> {losses[-1]:.6e} "
              f"(ratio {r['ratio']:.4f}, bar {r['bars'][0]}); max abs {leaf} "
              f"error {r['err0']:.4f} -> {r['err']:.4f} (bar {r['bars'][1]}):"
              f" bars {'met' if r['met'] else 'MISSED'}; losses "
              + ", ".join(f"{i}: {losses[i]:.4e}"
                          for i in range(0, CAMFIT_STEPS, 15)), flush=True)
        if min(got) < CAMFIT_STEPS:
            raise AssertionError(f"[camfit] {leaf}: the fit did not launch "
                                 f"both kernels every step: {got}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"[camfit] {leaf}: non-finite loss")
        if not r["met"]:
            missed.append(f"{leaf}: loss ratio {r['ratio']:.4f} (bar "
                          f"{r['bars'][0]}), error {r['err']:.4f} (bar "
                          f"{r['bars'][1]})")
        if leaf == "lookfrom":
            fitted_spec = dataclasses.replace(scene.camera, lookfrom=tuple(
                float(x) for x in r["fitted"][leaf].cpu()))
    if missed:
        raise AssertionError(f"[camfit] soft {soft}: the JAX recipe's bars "
                             f"are missed at full width: " + "; ".join(missed))
    return launches, fitted_spec, target


def camera_gradient_check(mode, scene, spec, target, cfg):
    """The camera leaves' gradient through kernel B within GRAD_TOL of the
    replay path's (render_image_mega(fused=False)) at `spec`; returns
    the fused (loss, lookfrom gradient, vfov gradient)."""
    fused = camfit_bench.camera_grad(scene.spheres, spec, target, cfg)
    replay = camfit_bench.camera_grad(scene.spheres, spec, target, cfg,
                                      fused=False)
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(fused[1:], replay[1:]))
    print(f"[camfit] {mode}: camera gradient, fused B against the replay: "
          f"lookfrom {[f'{g:.6e}' for g in fused[1].tolist()]} / "
          f"{[f'{g:.6e}' for g in replay[1].tolist()]}, vfov "
          f"{float(fused[2]):.6e} / {float(replay[2]):.6e}; worst relative "
          f"gap {rel:.2e}", flush=True)
    if not rel <= GRAD_TOL:
        raise AssertionError(f"[camfit] {mode}: the fused camera gradient "
                             f"is {rel} from the replay's")
    return fused


def camfit():
    """[camfit] The camera fit at full width on the "mega" engine, the JAX
    recipe (bench.camfit.CASES) through grad.inverse.fit_camera.

    Hard: the fixed-topology gradient has no silhouette terms, and at full
    width it points away from the true camera (ROADMAP.md §3, open fault
    1; the JAX package's does too, PERF.md §6), so the recipe's 120-step
    fits are not run here (bench.camfit runs them). At each moved start
    (lookfrom, vfov) the leaves' gradient through kernel B within GRAD_TOL
    of the replay's, printed beside central differences of the loss; on
    the moved lookfrom's frame kernels A and B against their plain versions
    (full_width); the hard camera step's path: camfit_bench.step_ms, two
    warm steps and ten timed, both kernels launched once a step.

    Soft (SOFT, the soft geometry fit's width): both recipe fits must meet
    the JAX bars; the camera gradient at the fitted lookfrom within
    GRAD_TOL of the replay's; the warm step.

    Returns ((A, B) launches of the hard camera step's path, of the soft
    fits, A's and B's full_width results on the camera frame)."""
    cfg = RenderConfig(**CAMFIT)
    soft_cfg = cfg.replace(soft_silhouette=SOFT)
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8,
                                        device="cuda")
    with torch.no_grad():
        target = render_for_loss(scene.spheres, scene.camera.build("cuda"),
                                 cfg, engine="mega")
    starts = {leaf: camfit_bench.moved(scene.camera, leaf, case[1])
              for leaf, case in camfit_bench.CASES.items()}
    for leaf, start in starts.items():
        _, g_lf, g_vf = camera_gradient_check(f"hard, moved {leaf}", scene,
                                              start, target, cfg)
        grad = g_vf.reshape(1) if leaf == "vfov" else g_lf
        numeric = camfit_bench.central_differences(
            scene.spheres, start, target, cfg, "mega", leaf)
        print(f"[camfit] hard: the loss's gradient in {leaf} at the moved "
              f"start, fixed-topology {[f'{g:.4e}' for g in grad.tolist()]},"
              f" central differences (eps 1e-3) "
              f"{[f'{g:.4e}' for g in numeric]}", flush=True)
    a_full, b_full = full_width("small", scene.spheres,
                                starts["lookfrom"].build("cuda"), cfg,
                                scene.n_real)
    reset_launches()
    ms = camfit_bench.step_ms(scene, starts["lookfrom"], target, cfg, "mega",
                              "cuda")
    hard = (megakernel.ONESHOT_LAUNCHES, mega_backward.LAUNCHES)
    print(f"[camfit] hard: warm camera step {ms:.2f} ms (host clock, the "
          f"loss read each step) on {card_line()}; launches topology "
          f"{hard[0]} backward {hard[1]}", flush=True)
    if hard != (12, 12):
        raise AssertionError(f"[camfit] hard: 12 camera steps launched "
                             f"{hard}")

    soft, soft_spec, soft_target = camfit_fits(scene, soft_cfg)
    camera_gradient_check(f"soft {SOFT}, fitted lookfrom", scene, soft_spec,
                          soft_target, soft_cfg)
    ms = camfit_bench.step_ms(scene, soft_spec, soft_target, soft_cfg,
                              "mega", "cuda")
    print(f"[camfit] soft {SOFT}: warm camera step {ms:.2f} ms (host clock, "
          f"the loss read each step) on {card_line()}", flush=True)
    return hard, soft, a_full, b_full


def tooling():
    """[tooling] The tooling on the card: bench.cli --scenes small --profile
    --report --save once, its Chrome trace holding the one-shot kernel's
    CUDA events, its report table the record just written, the native
    runtime built and its TGA the bytes of scene/tga.write_rgb24 and its
    tonemap the device's to_srgb_u8; device_memory_stats' peak; the
    one-rank point of bench.scaling (telemetry on). Returns the one-shot
    kernel's launches (the CLI's and the scaling point's) and its kIters
    instantiation's (the scaling point's telemetry)."""
    out_dir = tempfile.mkdtemp(prefix="rays1bench_tooling_")
    logdir = os.path.join(out_dir, "trace")
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--scenes", "small", "--profile", logdir, "--report",
                  "--save", "--out-dir", out_dir])
    text = buf.getvalue()
    launches = megakernel.ONESHOT_LAUNCHES
    for line in text.splitlines():
        print(f"[tooling] cli: {line}", flush=True)
    if launches < 2:
        raise AssertionError("[tooling] the CLI did not run the one-shot "
                             "kernel")
    traces = profiling.trace_files(logdir)
    if len(traces) != 1:
        raise AssertionError(f"[tooling] traces in {logdir}: {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    ran = sorted(k for k, fn in TRACE_FUNCTIONS.items()
                 if any(bench_grad.is_kernel(n, fn) for n in names))
    print(f"[tooling] {os.path.basename(traces[0])}: {len(events)} events, "
          f"{len(names)} CUDA kernel names; the port's kernels in it: {ran}",
          flush=True)
    if "oneshot" not in ran:
        raise AssertionError("[tooling] the trace holds no one-shot kernel "
                             "event")
    with open(os.path.join(out_dir, "out_small.txt")) as f:
        version, secs, rays, mrays = parse_record(f.read())
    rec, = report.collect([out_dir], "small")
    row = (f"| **{version}** | {secs:.3f} s | {rays:,} | **{mrays:.3f}** | "
           f"1.00 |")
    if (rec.version, rec.seconds, rec.rays, rec.mrays) != \
            (version, secs, rays, mrays) or row not in text:
        raise AssertionError(f"[tooling] the report does not hold the "
                             f"record {rec}")
    print(f"[tooling] the report's table holds out_small.txt: {row}",
          flush=True)

    if not native.available() or "native runtime: built" not in text:
        raise AssertionError(f"[tooling] native runtime: {native.status()}")
    img = tga.read_rgb24(os.path.join(out_dir, "out_small.tga"))
    plain = os.path.join(out_dir, "plain.tga")
    tga.write_rgb24(plain, img)
    with open(os.path.join(out_dir, "out_small.tga"), "rb") as a, \
            open(plain, "rb") as b:
        same = a.read() == b.read()
    cfg = get_config("quick")
    scene = builders.create_small_scene(cfg.aspect, device="cuda")
    frame, _ = render_image_megakernel(scene.spheres,
                                       scene.camera.build("cuda"), cfg,
                                       n_real=scene.n_real)
    tone = np.array_equal(native.tonemap_u8(frame.cpu().numpy()),
                          to_srgb_u8(frame).cpu().numpy())
    print(f"[tooling] native runtime {native.status()}: out_small.tga "
          f"{img.shape} equal to scene/tga.write_rgb24's bytes: {same}; "
          f"tonemap_u8 of a quick frame equal to to_srgb_u8 on the card: "
          f"{tone}", flush=True)
    if not (same and tone):
        raise AssertionError("[tooling] the native runtime differs from its "
                             "plain twins")
    stats = profiling.device_memory_stats("cuda")
    peak = stats["allocated_bytes.all.peak"]
    print(f"[tooling] device_memory_stats: peak {peak / 2**30:.2f} GiB "
          f"allocated, {stats['allocated_bytes.all.current'] / 2**30:.2f} "
          f"GiB now", flush=True)
    if not peak > 0:
        raise AssertionError("[tooling] no peak in device_memory_stats")

    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        points, telems = scaling.main(["--scene", "small", "--devices", "1",
                                       "--telemetry"])
    launches += megakernel.ONESHOT_LAUNCHES
    iters_launches = megakernel.ONESHOT_ITERS_LAUNCHES
    for line in buf.getvalue().splitlines():
        print(f"[tooling] scaling: {line}", flush=True)
    if not (len(points) == 1 and points[0].n_devices == 1
            and points[0].num_rays == telems[0]["device_rays"][0] > 0
            and iters_launches):
        raise AssertionError(f"[tooling] scaling point {points} {telems}")
    return launches, iters_launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    started = time.perf_counter()
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib.name}: {line.strip()}", flush=True)

    results = [compare_case(*case) for case in CASES]
    _, k_ms, p_ms, r_bound, r_iters = results[0]
    r_iters = (max(r[4][0] for r in results),) + r_iters[1:]

    launches, img, rays = headline()
    head_err, _, _, _, head_cnt = headline_vs_plain(img, rays)
    occupancy(head_cnt)
    head_iters = headline_iters(head_cnt)
    max_err = max([r[0] for r in results] + [head_err])

    grad = [grad_case(*case) for case in GRAD_CASES]
    scene, camera, cfg, fitted, medium_launches = fit("medium", 8, 5)
    kernels_alone("medium", scene, camera, cfg, fitted)
    a_full, b_full = full_width("medium", fitted, camera, cfg, scene.n_real)
    scene, camera, _, fitted, large_launches = fit("large", 128, 1)
    kernels_alone("large", scene, camera, cfg, fitted)
    a_large, b_large = full_width("large", fitted, camera, cfg, scene.n_real)
    grad_launches = [m + n for m, n in zip(medium_launches, large_launches)]
    a_err = max([g[0] for g in grad] + [a_full[0], a_large[0]])
    b_err = max([g[1] for g in grad] + [b_full[0], b_large[0]])
    print(f"[mem] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    soft_errs = [grad_case(*case, soft=SOFT) for case in SOFT_CASES]
    scene, camera, cfg, fitted, soft_launches, _ = soft_fit()
    a_soft, b_soft = full_width("small", fitted, camera, cfg, scene.n_real)
    a_soft = (max([e[0] for e in soft_errs] + [a_soft[0]]),) + a_soft[1:]
    b_soft = (max([e[1] for e in soft_errs] + [b_soft[0]]),) + b_soft[1:]
    soft_timings()

    index = index_checks()
    phase_err = max(phase_case(*case) for case in PHASE_CASES)
    (*engine_launches, one_err, phase, one_iters, one_cost,
     frames) = engines_full()
    phase = (max(phase_err, phase[0]),) + phase[1:]
    a_err = max(a_err, one_err)
    cli_launches = cli_run()
    pipeline_index_vs_sweep()
    index_launches, bounce_err = pipeline_checks()
    index = (max(index[0], bounce_err),) + index[1:]

    t0 = time.perf_counter()
    shard_local(frames)
    shard_rel = shard_gradient()
    shard_launches = shard_group(img, rays, frames)
    print(f"[shard] every check in {time.perf_counter() - t0:.1f} s; the "
          f"sharded fused gradient's worst relative gap {shard_rel:.2e}; "
          f"kIters cost (off, on) ms: respawn headline "
          f"({head_iters[0]:.3f}, {head_iters[1]:.3f}), one-shot CLI frame "
          f"({one_cost[0]:.3f}, {one_cost[1]:.3f})", flush=True)
    t0 = time.perf_counter()
    cam_hard, cam_soft, a_cam, b_cam = camfit()
    print(f"[camfit] every check in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    tool_launches, tool_iters = tooling()
    print(f"[tooling] every check in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"[time] every phase in {time.perf_counter() - started:.1f} s",
          flush=True)

    print(f"[card] {card}")
    print(json.dumps({"kernels": [
        kernel_entry("respawn", "respawn.cu",
                     "rays1bench_tpu/kernels/megakernel.py:553",
                     launches + shard_launches["respawn"], max_err, k_ms,
                     p_ms, r_bound),
        kernel_entry("oneshot", "oneshot.cu",
                     "rays1bench_tpu/kernels/megakernel.py:487",
                     grad_launches[0] + engine_launches[0] + cli_launches
                     + shard_launches["oneshot"] + tool_launches, a_err,
                     *a_full[1:]),
        kernel_entry("mega_backward", "mega_backward.cu",
                     "rays1bench_tpu/kernels/mega_backward.py:227",
                     grad_launches[1] + shard_launches["mega_backward"],
                     b_err, *b_full[1:]),
        kernel_entry("oneshot_camera", "oneshot.cu",
                     "rays1bench_tpu/kernels/megakernel.py:487",
                     cam_hard[0], *a_cam),
        kernel_entry("mega_backward_camera", "mega_backward.cu",
                     "rays1bench_tpu/kernels/mega_backward.py:227",
                     cam_hard[1], *b_cam),
        kernel_entry("oneshot_soft", "oneshot.cu",
                     "rays1bench_tpu/kernels/megakernel.py:487",
                     soft_launches[0] + cam_soft[0], *a_soft),
        kernel_entry("mega_backward_soft", "mega_backward.cu",
                     "rays1bench_tpu/kernels/mega_backward.py:227",
                     soft_launches[1] + cam_soft[1], *b_soft),
        kernel_entry("intersect_index", "intersect_index.cu",
                     "rays1bench_tpu/kernels/intersect_pallas.py:34",
                     index_launches + shard_launches["intersect_index"],
                     *index),
        kernel_entry("phase", "phase.cu",
                     "rays1bench_tpu/kernels/megakernel.py:706",
                     engine_launches[1] + shard_launches["phase"], *phase),
        kernel_entry("respawn_iters", "respawn.cu",
                     "rays1bench_tpu/kernels/megakernel.py:553",
                     shard_launches["respawn_iters"], *r_iters),
        kernel_entry("oneshot_iters", "oneshot.cu",
                     "rays1bench_tpu/kernels/megakernel.py:487",
                     shard_launches["oneshot_iters"] + tool_iters,
                     *one_iters),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
