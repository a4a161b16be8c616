"""Scaling sweep: rays/s against rank count (rays1bench_tpu/bench/scaling.py).

    python -m rays1bench_tpu_torch.bench.scaling [--scene medium]
        [--width 400] [--height 200] [--spp 4] [--max-bounces 10]
        [--devices 1,2,4] [--runs 2] [--engine kernel|plain] [--respawn]
        [--telemetry] [--cpu] [--record FILE]
    torchrun --nproc-per-node N -m rays1bench_tpu_torch.bench.scaling ...

Each point of the sweep renders the frame over a 1-D mesh of the group's
first n ranks, on a subgroup of its own (parallel/mesh.make_submesh),
through parallel/shard: --engine kernel (the default, the JAX sweep's
"pallas") by render_image_pallas_sharded, the one-shot kernel engine or
with --respawn the respawn engine; --engine plain by render_image_sharded.
A point's time is the best of --runs frames after a warm one, on rank 0's
host clock around the render and a device synchronize (the render ends in
an all_gather, so rank 0 waits for the slowest rank). Rays and times go
through utils/metrics (ScalingPoint, scaling_efficiency). --telemetry
(kernel engine) then renders TELEMETRY_FRAMES frames with telemetry in a
utils/profiling.session() and adds each rank's rays and warp loop trips of
the last (the kernels' kIters counters), the load-imbalance signal, and,
from rank 0's recorder (parallel/shard.rank_timings), each rank's median
over the frames of its "local" ms (its kernel_local) and its ms from
reaching the all_reduce to the end of the all_gather (stream ms on the
card, host ms on gloo CPU ranks), and its host's issue of a frame (the
"frame" span's host ms). A rank sends a
frame's times with a later frame's gather, so the last frame's arrive
with none. The busiest rank (most trips) that waits little in the
collectives sets the pace; ranks that wait long are held by it.

The ranks: under torchrun, its group (NCCL on the card); on one card
without torchrun, a group of one, so only the one-rank point runs. With
--cpu the plain versions run on gloo CPU ranks: under torchrun its group,
else max(--devices) ranks that parallel/dryrun.run_ranks starts.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import tempfile
import time
from typing import List

import torch
import torch.distributed as dist

from rays1bench_tpu_torch.utils import profiling
from rays1bench_tpu_torch.utils.metrics import ScalingPoint, scaling_efficiency

TELEMETRY_FRAMES = 4
RANK_MS = ("local_ms", "collective_ms", "issue_ms")


def sweep(scene_name: str, cfg, device_counts: List[int], runs: int = 2,
          engine: str = "kernel", respawn: bool = False,
          telemetry: bool = False, device="cuda"):
    """Run on every rank of the process group. Returns (points, telemetry)
    on rank 0, None on the others: points a list of ScalingPoint, one per
    count; telemetry (with telemetry=True, kernel engine only; else None)
    a parallel list of {"device_rays": [...], "device_iters": [...],
    "local_ms": [...], "collective_ms": [...], "issue_ms": [...]}, one
    entry per rank of the point (telemetry_frames)."""
    from rays1bench_tpu_torch.parallel.mesh import make_submesh
    from rays1bench_tpu_torch.parallel.shard import (
        render_image_pallas_sharded, render_image_sharded)
    from rays1bench_tpu_torch.scene import builders

    if telemetry and engine != "kernel":
        raise ValueError("telemetry rides the kernels' trip counters "
                         "(--engine kernel)")
    scene = builders.SCENES[scene_name](cfg.aspect, device=device)
    camera = scene.camera.build(device)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)

    def render(mesh, **kw):
        if engine == "plain":
            return render_image_sharded(scene.spheres, camera, cfg, mesh)
        return render_image_pallas_sharded(scene.spheres, camera, cfg, mesh,
                                           n_real=scene.n_real or None,
                                           respawn=respawn, **kw)

    points, telems = [], []
    with torch.no_grad():
        for n in device_counts:
            mesh = make_submesh(n, device=device)
            if mesh is not None:
                _, rays = render(mesh)
                sync()
                best = float("inf")
                for _ in range(runs):
                    t0 = time.perf_counter()
                    _, rays = render(mesh)
                    sync()
                    best = min(best, time.perf_counter() - t0)
                points.append(ScalingPoint(n, int(rays), best))
                if telemetry:
                    telems.append(telemetry_frames(render, mesh, sync))
            dist.barrier()
    if dist.get_rank() != 0:
        return None
    return points, (telems if telemetry else None)


def telemetry_frames(render, mesh, sync, frames: int = TELEMETRY_FRAMES):
    """`frames` telemetry frames, each synchronised, in a
    profiling.session(): {"device_rays", "device_iters"} of the last, and
    per rank of the mesh its median RANK_MS over the frames whose times
    arrived (None where none did)."""
    from rays1bench_tpu_torch.parallel.shard import rank_timings

    with profiling.session():
        for _ in range(frames):
            _, _, tl = render(mesh, telemetry=True)
            sync()
    out = {k: v.reshape(-1).tolist() for k, v in tl.items()}
    timings = [t["ranks"] for t in rank_timings().values()]
    for k in RANK_MS:
        out[k] = []
        for r in range(len(out["device_rays"])):
            got = [t[r][k] for t in timings if r in t]
            out[k].append(statistics.median(got) if got else None)
    return out


def _sweep_rank(*args):
    """sweep on one gloo rank that parallel.dryrun.run_ranks started, its
    points as plain tuples (run_ranks loads results with weights_only)."""
    out = sweep(*args, device="cpu")
    return out and ([dataclasses.astuple(p) for p in out[0]], out[1])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="rays1bench_tpu_torch.bench.scaling")
    ap.add_argument("--scene", default="medium")
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=200)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-bounces", type=int, default=10)
    ap.add_argument("--devices", default="",
                    help="comma-separated rank counts (default: 1, 2, 4, "
                         "... up to the group's size)")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--engine", default="kernel", choices=["kernel", "plain"],
                    help="kernel = the one-shot (or --respawn) kernel "
                         "engine, sharded; plain = the sharded plain "
                         "pipeline")
    ap.add_argument("--respawn", action="store_true",
                    help="the respawn engine (kernel engine only)")
    ap.add_argument("--telemetry", action="store_true",
                    help="also each rank's rays and warp loop trips")
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions on gloo CPU ranks")
    ap.add_argument("--record", default="",
                    help="append 'label|devices|seconds|rays|mrays|eff|' "
                         "lines here (bench/report_cli.scaling_table)")
    return ap.parse_args(argv)


def main(argv=None):
    from rays1bench_tpu_torch.bench.cli import sharded_mesh
    from rays1bench_tpu_torch.core.config import RenderConfig

    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rays1bench_tpu_torch.bench.scaling needs a CUDA "
                         "device (or --cpu)")
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_bounces=args.max_bounces, ray_chunk=16384)
    world = int(os.environ.get("WORLD_SIZE", 0))
    counts = [int(x) for x in args.devices.split(",") if x]
    size = world or (max(counts) if counts and args.cpu else 1)
    counts = counts or [c for c in (1, 2, 4, 8, 16) if c <= size]
    if max(counts) > size:
        raise SystemExit(f"--devices {args.devices} in a group of {size} "
                         f"ranks (torchrun --nproc-per-node N for N)")
    sweep_args = (args.scene, cfg, counts, args.runs, args.engine,
                  args.respawn, args.telemetry)
    if args.cpu and not world and size > 1:
        from rays1bench_tpu_torch.parallel.dryrun import run_ranks
        with tempfile.TemporaryDirectory(prefix="rays1bench_scaling_") as d:
            points, telems = run_ranks(_sweep_rank, size, d, *sweep_args)[0]
        out = [ScalingPoint(*p) for p in points], telems
    else:
        _, started = sharded_mesh(size, device)
        try:
            out = sweep(*sweep_args, device=device)
        finally:
            if started:
                dist.destroy_process_group()
    if out is None:
        return None
    print_sweep(args, out, device)
    return out


def print_sweep(args, out, device):
    """Print the sweep (and append it to --record)."""
    from rays1bench_tpu_torch.bench.profile import smi

    points, telems = out
    effs = scaling_efficiency(points)
    where = (f"{smi('name', 'power.limit')[0]}" if device == "cuda"
             else "gloo CPU ranks (plain versions; not a device time)")
    print(f"scaling {args.scene} {args.width}x{args.height} @ {args.spp} spp "
          f"@ {args.max_bounces} b, {args.engine}"
          f"{' respawn' if args.respawn else ''}: {where}")
    print(f"{'devices':>8} {'rays':>12} {'seconds':>10} {'mrays/s':>10} "
          f"{'efficiency':>10}")
    for i, (p, e) in enumerate(zip(points, effs)):
        print(f"{p.n_devices:>8} {p.num_rays:>12} {p.elapsed_seconds:>10.6f} "
              f"{p.mrays:>10.2f} {e:>10.2%}")
        if telems:
            print(f"         per-rank rays  {telems[i]['device_rays']}")
            print(f"         per-rank trips {telems[i]['device_iters']}")
            for k in RANK_MS:
                ms = ", ".join("-" if v is None else f"{v:.3f}"
                               for v in telems[i][k])
                print(f"         per-rank {k} (median) [{ms}]")
    if args.record:
        os.makedirs(os.path.dirname(args.record) or ".", exist_ok=True)
        label = (f"{args.scene} {args.width}x{args.height} @ {args.spp} spp, "
                 f"{args.engine}{' respawn' if args.respawn else ''}, "
                 f"{device}")
        with open(args.record, "a") as f:
            for i, (p, e) in enumerate(zip(points, effs)):
                f.write(f"{label}|{p.n_devices}|{p.elapsed_seconds:.6f}s|"
                        f"{p.num_rays}|{p.mrays:.3f}|{e:.3f}|\n")
                if telems:
                    f.write(f"# per-rank rays {telems[i]['device_rays']} "
                            f"trips {telems[i]['device_iters']}\n")


if __name__ == "__main__":
    main()
