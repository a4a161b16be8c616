#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rays1bench_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Requires a CUDA device and prints the card's name and power limit.
2. Builds the respawn kernel from kernels/csrc with nvcc (sm_90a) and prints
   the build time and ptxas's register report.
3. Holds the kernel against its plain PyTorch version on the card, on the
   same inputs: per-pixel ray counts and the 64-bit total must be equal and
   per-pixel sample sums within SUM_TOL. A two-span split of the samples is
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
Then prints one JSON line of per-kernel results and, last, the device line.
Any failure raises and exits non-zero before the last line.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rays1bench_tpu_torch.bench.harness import benchmark_sustained
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import build, megakernel
from rays1bench_tpu_torch.kernels.pipeline import (prepare_trimmed,
                                                   render_image_megakernel)
from rays1bench_tpu_torch.render.pipeline import to_srgb_u8
from rays1bench_tpu_torch.scene import builders, tga

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


def cuda_ms(fn, reps=1):
    """Mean milliseconds of fn() over reps calls, between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


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
    ms, plain ms)."""
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
    return err, k_ms, p_ms


def block_means(img):
    h, w, c = img.shape
    return img.reshape(h // BLOCK, BLOCK, w // BLOCK, BLOCK, c).mean(axis=(1, 3))


def headline():
    """The main path at the headline workload; returns (kernel launches,
    image, rays per frame)."""
    cfg = HEADLINE
    scene = builders.SCENES["large"](cfg.aspect, device="cuda")
    megakernel.LAUNCHES = 0
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
    lib = build.build("respawn", "respawn.cu")
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}", flush=True)

    results = [compare_case(*case) for case in CASES]
    _, k_ms, p_ms = results[0]

    launches, img, rays = headline()
    head_err, _, _, _ = headline_vs_plain(img, rays)
    max_err = max([r[0] for r in results] + [head_err])

    print(f"[card] {card}")
    print(json.dumps({"kernels": [{
        "name": "respawn",
        "route": "cuda",
        "source": "rays1bench_tpu_torch/kernels/csrc/respawn.cu",
        "replaces": "rays1bench_tpu/kernels/megakernel.py:553",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
