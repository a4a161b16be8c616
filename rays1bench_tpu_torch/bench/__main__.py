"""Headline benchmark of the port on one CUDA GPU.

    python -m rays1bench_tpu_torch.bench [--scene large] [--spp 250]
        [--max-bounces 50] [--frames 2] [--runs 1] [--quick]

Prints bench.py's one JSON line for the port,
  {"metric": "mrays_per_sec_<scene>_<W>x<H>_<spp>spp", "value": N,
   "unit": "mrays/s", "vs_baseline": N},
with the same metric: sustained rays per second on the large scene at the
reference's published workload, 1280x720 @ 250 spp @ 50 bounces, rays
counted per radiance evaluation including bounces. vs_baseline divides by
the reference's step13 multithreaded large-scene number, 59.362 mrays/s
(bench.py:35). A stderr line names the card. Raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

BASELINE_MRAYS = 59.362  # reference step13 MT, large scene (bench.py:35)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rays1bench_tpu_torch.bench")
    ap.add_argument("--scene", default="large",
                    choices=["small", "medium", "large", "giant"])
    ap.add_argument("--spp", type=int, default=250)
    ap.add_argument("--max-bounces", type=int, default=50)
    ap.add_argument("--frames", type=int, default=2,
                    help="frames per timed run, queued back to back")
    ap.add_argument("--runs", type=int, default=1, help="timed runs; best kept")
    ap.add_argument("--quick", action="store_true", help="80x60 smoke config")
    args = ap.parse_args(argv)

    import torch

    from rays1bench_tpu_torch.bench.harness import benchmark_sustained
    from rays1bench_tpu_torch.core.config import RenderConfig
    from rays1bench_tpu_torch.scene import builders

    if not torch.cuda.is_available():
        raise SystemExit("rays1bench_tpu_torch.bench needs a CUDA device")
    w, h = (80, 60) if args.quick else (1280, 720)
    cfg = RenderConfig(width=w, height=h, spp=args.spp,
                       max_bounces=args.max_bounces)
    scene = builders.SCENES[args.scene](cfg.aspect, device="cuda")
    res = benchmark_sustained(scene, cfg, frames=args.frames,
                              num_runs=args.runs)
    mrays = res.mrays_per_sec
    print(json.dumps({
        "metric": f"mrays_per_sec_{args.scene}_{cfg.width}x{cfg.height}_{cfg.spp}spp",
        "value": round(mrays, 3),
        "unit": "mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
    }))
    print(f"# sustained: rays={res.num_rays} frames={args.frames} "
          f"total={res.elapsed_seconds:.4f}s "
          f"per_frame={res.elapsed_seconds / args.frames * 1e3:.1f}ms "
          f"device={torch.cuda.get_device_name(0)}", file=sys.stderr)


if __name__ == "__main__":
    main()
