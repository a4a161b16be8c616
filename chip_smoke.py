#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rays1bench_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Requires a CUDA device and prints the card's name and power limit.
2. Builds the three kernels from kernels/csrc with nvcc (sm_90a), one nvcc
   each, all started together, and prints the build time and ptxas's
   register and spill report.
3. Holds the respawn kernel against its plain PyTorch version on the card,
   on the same inputs: per-pixel ray counts and the 64-bit total must be
   equal and per-pixel sample sums within SUM_TOL. A two-span split of the samples is
   held against the full span.
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
   does not depend on the other rays), and ~4k of its rays (a pixel block,
   the last column, the top row, the corners and seeded picks) as their own
   ray list, whose topology and ray cotangents must equal the whole-frame
   launch's bit for bit.
Then prints one JSON line of per-kernel results and, last, the device line.
The gradient kernels' launches there are those of both fits; their times
and bounds are the medium frame's, their max_abs_err the worst of every
comparison. Any failure raises and exits non-zero before the last line.

Bounds: a kernel's bound is the larger of its bytes (each input read once,
each output written once) over HBM_BYTES_PER_S and its FP32 operations over
FP32_OPS_PER_S. The kernels are built with --fmad=false, so an add or a
multiply is one instruction: the card's 67 TFLOP/s FP32 peak counts a fused
multiply-add as two operations, and a stream of plain adds and multiplies
peaks at half of it. Operations are counted from this run's data: a sweep
costs SWEEP_OPS per sphere row and traced ray, a replayed bounce of the
backward BACKWARD_OPS per live bounce.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rays1bench_tpu_torch.bench.grad import (ALBEDOS, cuda_ms, kernel_ms,
                                             launch_ms, perturb_albedos)
from rays1bench_tpu_torch.bench.harness import benchmark_sustained
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad.inverse import (InverseConfig, fit_scene,
                                               make_train_step, params_of,
                                               render_for_loss)
from rays1bench_tpu_torch.kernels import build, mega_backward, megakernel
from rays1bench_tpu_torch.kernels.pipeline import (prepare_trimmed,
                                                   ray_coords,
                                                   render_image_megakernel)
from rays1bench_tpu_torch.render.pipeline import primary_rays, to_srgb_u8
from rays1bench_tpu_torch.scene import builders, tga
from rays1bench_tpu_torch.scene.spheres import prepare

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "latest_full_large.tga")

# Kernel vs plain version, both on the card. The kernel is compiled with
# --fmad=false and IEEE division and sqrt, and every torch op is its own
# IEEE float32 op, so the two should agree bit for bit.
SUM_TOL = 0.0
# A two-span split adds the two partial sums once instead of adding the
# samples one by one: float addition order only.
SPLIT_TOL = 1e-5
REFERENCE_RAYS = 631_145_620   # tests/golden/README.md:15-19
RAY_TOL = 3e-3                 # tests/test_pipeline.py:88
GOLDEN_TOL_MEAN, GOLDEN_TOL_MAX, BLOCK = 1.25, 3.5, 16   # tools/verify_golden.py
HEADLINE = RenderConfig(width=1280, height=720, spp=250, max_bounces=50)
PIXEL_SEED = 7

# The fused backward against backward_reference: both float32, but the
# kernel adds its column sums with atomics in an order that changes from
# run to run and follows its hand-derived adjoint's operation order, where
# autograd follows its own. Max abs gap per column (and per ray plane) over
# the column's max abs value. Host-compiled rehearsal of the same adjoint
# against autograd: <= 2.5e-5.
GRAD_TOL = 1e-3
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
PLAIN_CHUNK = 1 << 19

GRAD_CASES = [  # (name, scene, width, height, spp, max_bounces, pad)
    ("small 64x32 @ 2 spp @ 3 b", "small", 64, 32, 2, 3, 8),
    ("small 64x32 @ 2 spp @ 5 b", "small", 64, 32, 2, 5, 8),
    ("medium 160x90 @ 4 spp @ 10 b", "medium", 160, 90, 4, 10, 8),
    ("large 160x90 @ 4 spp @ 10 b (512 rows)", "large", 160, 90, 4, 10, 128),
]
FULL = dict(width=1280, height=720, spp=4, max_bounces=10, seed=FIT_SEED,
            early_exit=False)

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
    return err, k_ms, p_ms, respawn_bound(cfg.num_pixels, packed.shape[1],
                                          int(k_total))


def reset_launches():
    megakernel.LAUNCHES = 0
    megakernel.ONESHOT_LAUNCHES = 0
    mega_backward.LAUNCHES = 0


def bound_ms(n_bytes, n_ops):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def respawn_bound(npix, s_count, rays):
    """Table and camera in, 3 sums and a count per pixel out; a sweep of
    every row per traced ray."""
    return bound_ms(4 * (7 * s_count + 19 + 4 * npix),
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


def grad_inputs(scene_name, cfg, pad):
    """(scene, prepared spheres, primary rays, ray ids) on the card, rays in
    ray-id order."""
    scene = builders.SCENES[scene_name](cfg.aspect, pad_multiple=pad,
                                        device="cuda")
    camera = scene.camera.build("cuda")
    ray_id, x, y = ray_coords(cfg, "cuda")
    rays = [r.contiguous() for r in primary_rays(camera, cfg, x, y, ray_id)]
    return scene, prepare(scene.spheres), rays, ray_id


def random_cts(n, seed):
    """Per-ray radiance cotangents, uniform in [-0.5, 0.5), from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.rand(n, generator=g, device="cuda") - 0.5
            for _ in range(3)]


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


def grad_gap(label, k, p, n_real):
    """k, p: (grads, ray cotangents) of kernel and plain version; raise
    unless every column and ray plane is within GRAD_TOL, placeholder rows
    are exactly 0 and all is finite; returns (worst relative gap, max abs
    gap)."""
    got = list(k[0]) + list(k[1])
    want = list(p[0]) + list(p[1])
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not all(bool(torch.isfinite(a).all()) for a in got):
        raise AssertionError(f"{label}: non-finite cotangents")
    if k[0].shape[1] > n_real and float(k[0][:, n_real:].abs().max()) != 0:
        raise AssertionError(f"{label}: placeholder rows got a gradient")
    if not rel <= GRAD_TOL:
        raise AssertionError(f"{label}: fused backward vs backward_reference "
                             f"relative gap {rel}")
    return rel, err


def grad_case(label, scene_name, w, h, spp, mb, pad):
    """Both gradient kernels against their plain versions on the card;
    returns (topology radiance gap, backward max abs gap)."""
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb,
                       seed=FIT_SEED, early_exit=False)
    scene, prep, rays, ray_id = grad_inputs(scene_name, cfg, pad)
    packed = megakernel.pack_spheres(prep)
    fwd = lambda: megakernel.trace_topology(packed, *rays, ray_id, cfg)
    fwd()
    (k_rad, k_cnt, k_total, topo), a_ms, _, _ = launch_ms(fwd)
    plain, a_plain_ms = cuda_ms(lambda: megakernel.trace_topology_reference(
        packed, *rays, ray_id, cfg))
    a_err = topology_gap(label, (k_rad, k_cnt, topo), plain)
    if int(k_total) != int(k_cnt.sum(dtype=torch.int64)):
        raise AssertionError(f"{label}: topology kernel ray total differs")
    cts = random_cts(ray_id.numel(), 1)
    bwd = lambda: mega_backward.backward(prep, *rays, ray_id, *cts, topo,
                                         cfg)
    bwd()
    k, b_ms, _, _ = launch_ms(bwd)
    p, b_plain_ms = cuda_ms(lambda: mega_backward.backward_reference(
        prep, *rays, ray_id, *cts, topo, cfg))
    rel, b_err = grad_gap(label, k, p, scene.n_real)
    print(f"[grad] {label}: {prep.count} rows, {int(k_total)} rays | "
          f"topology kernel {a_ms:.3f} ms, plain {a_plain_ms:.1f} ms: "
          f"topology, counts and radiance equal | fused backward "
          f"{b_ms:.3f} ms, plain {b_plain_ms:.1f} ms: worst relative gap "
          f"{rel:.2e}, max abs gap {b_err:.2e}", flush=True)
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
    their own list. Returns per-kernel (max abs gap, ms, plain ms, bound)."""
    label = (f"{name} ({fitted.count} rows) {cfg.width}x{cfg.height} @ "
             f"{cfg.spp} spp @ {cfg.max_bounces} b")
    prep = prepare(fitted)
    ray_id, x, y = ray_coords(cfg, "cuda")
    rays = [r.contiguous() for r in primary_rays(camera, cfg, x, y, ray_id)]
    n, s_count, mb = ray_id.numel(), prep.count, cfg.max_bounces
    packed = megakernel.pack_spheres(prep)

    fwd = lambda: megakernel.trace_topology(packed, *rays, ray_id, cfg)
    fwd()
    (k_rad, k_cnt, k_total, topo), a_ms, _, _ = launch_ms(fwd)
    parts, a_plain_ms = cuda_ms(lambda: plain_chunked(
        lambda *t: megakernel.trace_topology_reference(packed, *t, cfg), n,
        *rays, ray_id))
    plain = (tuple(torch.cat([q[0][c] for q in parts]) for c in range(3)),
             torch.cat([q[1] for q in parts]),
             torch.cat([q[2] for q in parts], dim=1))
    a_err = topology_gap(label, (k_rad, k_cnt, topo), plain)
    rays_traced = int(k_total)

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
    rel, b_err = grad_gap(label, (k_grads, k_cts), (p_grads, p_cts), n_real)
    print(f"[full] {label}: {n} rays, {rays_traced} traced | topology "
          f"kernel {a_ms:.3f} ms, plain {a_plain_ms:.1f} ms (chunks of "
          f"{PLAIN_CHUNK}): equal | fused backward {b_ms:.3f} ms, plain "
          f"{b_plain_ms:.1f} ms: worst relative gap {rel:.2e}, max abs gap "
          f"{b_err:.2e}", flush=True)

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
    s_rel, _ = grad_gap(f"{label}, {idx.numel()} rays",
                        (s_grads, s_ray_cts),
                        mega_backward.backward_reference(
                            prep, *sub, sub_id, *s_cts, s_topo, cfg), n_real)
    print(f"[full] {label}, {idx.numel()} rays launched alone: topology, "
          f"counts, radiance and ray cotangents equal to the frame's launch "
          f"bit for bit; against the plain versions topology equal, "
          f"backward worst relative gap {s_rel:.2e}", flush=True)
    return ((a_err, a_ms, a_plain_ms,
             oneshot_bound(n, s_count, mb, rays_traced)),
            (b_err, b_ms, b_plain_ms,
             backward_bound(n, s_count, mb, rays_traced)))


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
    on the card. Returns (max abs sum gap, kernel ms, plain ms, pixels)."""
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
    return err, k_ms, p_ms, pid.numel()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
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
    _, k_ms, p_ms, r_bound = results[0]

    launches, img, rays = headline()
    head_err, _, _, _ = headline_vs_plain(img, rays)
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

    print(f"[card] {card}")
    print(json.dumps({"kernels": [
        kernel_entry("respawn", "respawn.cu",
                     "rays1bench_tpu/kernels/megakernel.py:553", launches,
                     max_err, k_ms, p_ms, r_bound),
        kernel_entry("oneshot", "oneshot.cu",
                     "rays1bench_tpu/kernels/megakernel.py:487",
                     grad_launches[0], a_err, *a_full[1:]),
        kernel_entry("mega_backward", "mega_backward.cu",
                     "rays1bench_tpu/kernels/mega_backward.py:227",
                     grad_launches[1], b_err, *b_full[1:]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
