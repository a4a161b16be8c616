"""Multi-scene benchmark CLI on one CUDA GPU (rays1bench_tpu/bench/cli.py;
reference: bench.py:10-38, binary flags -w/-n at rayweek1.cpp:943-958).

    python -m rays1bench_tpu_torch.bench.cli [--scenes small,medium,large]
        [--quick] [--save] [--num N] [--spp S] [--max-bounces B]
        [--engine kernel|plain] [--respawn] [--sustained FRAMES]
        [--sharded N] [--out-dir DIR] [--label LABEL] [--report]
        [--profile LOGDIR]
    torchrun --nproc-per-node N -m rays1bench_tpu_torch.bench.cli \
        --sharded N ...

The same flags and defaults as the JAX CLI. The config is the "full"
preset (1280x720 @ 10 spp @ 50 bounces), or "quick" (80x60 @ 4 spp) with
--quick. --engine kernel (the JAX CLI's "pallas", the default) renders
through the one-shot kernel engine, or the respawn engine with --respawn;
--engine plain (the JAX CLI's "xla") through the plain render.pipeline.
render_image on the card. For each scene it writes out_<scene>.txt in the
reference's pipe format (bench.harness.log_results), out_<scene>.tga with
--save (written by the native runtime, runtime/native.py), and prints the
JAX CLI's per-scene block; the card's name and power limit come first, then
the native runtime's status (built, or the numpy twins instead, and why).
--report prints each scene's markdown table of the records in --out-dir
afterwards (bench/report.py); --profile LOGDIR traces the benchmark runs
with torch.profiler into a Chrome trace in LOGDIR, the card's kernels
included (utils/profiling.py).

--sharded N renders over a mesh of N ranks, one card each
(parallel/shard.py): --engine kernel through render_image_pallas_sharded
(with --respawn its respawn engine), --engine plain through
render_image_sharded. N must be the size of the process group that
torchrun started (its environment names the group); for N = 1 without
one, the CLI makes a group of one. Every rank renders; rank 0 alone prints
and writes.

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="rays1bench_tpu_torch.bench.cli")
    ap.add_argument("--scenes", default="small,medium,large")
    ap.add_argument("--quick", action="store_true",
                    help="80x60 QUICKBENCH profile (common.h:3-15)")
    ap.add_argument("--save", "-w", action="store_true",
                    help="write out_<scene>.tga (rayweek1.cpp:943-947)")
    ap.add_argument("--num", "-n", type=int, default=1,
                    help="runs per scene, averaged (rayweek1.cpp:949-958)")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--max-bounces", type=int, default=None)
    ap.add_argument("--engine", default="kernel", choices=["kernel", "plain"],
                    help="the kernel engines (default) or the plain torch "
                         "pipeline")
    ap.add_argument("--respawn", action="store_true",
                    help="the respawn engine, one thread per pixel (kernel "
                         "engine only)")
    ap.add_argument("--sharded", type=int, default=0, metavar="NDEV",
                    help="render over a mesh of NDEV ranks (torchrun; a "
                         "group of one is made for 1)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--label", default=None,
                    help="version label written to out_<scene>.txt "
                         "(default: the harness VERSION_NAME)")
    ap.add_argument("--report", action="store_true",
                    help="print the markdown results table afterwards")
    ap.add_argument("--sustained", type=int, default=0, metavar="FRAMES",
                    help="time FRAMES frames queued back to back "
                         "(bench.harness.benchmark_sustained)")
    ap.add_argument("--profile", default="", metavar="LOGDIR",
                    help="trace the benchmark runs with torch.profiler into "
                         "LOGDIR (Chrome trace; utils/profiling.py)")
    args = ap.parse_args(argv)
    if not 1 <= args.num <= 31:  # the reference clamps -n to 1..31
        ap.error("--num must be in 1..31")
    from rays1bench_tpu_torch.scene import builders
    args.scene_names = [s.strip() for s in args.scenes.split(",")
                        if s.strip()]
    unknown = [s for s in args.scene_names if s not in builders.SCENES]
    if unknown:
        ap.error(f"unknown scene(s) {unknown}; choose from "
                 f"{sorted(builders.SCENES)}")
    return args


def config(args):
    """get_config("quick" or "full") with --spp and --max-bounces."""
    from rays1bench_tpu_torch.core.config import get_config
    cfg = get_config("quick" if args.quick else "full")
    if args.spp:
        cfg = cfg.replace(spp=args.spp)
    if args.max_bounces is not None:
        cfg = cfg.replace(max_bounces=args.max_bounces)
    return cfg


def render_fn(args, scene, mesh=None):
    """(spheres, camera, cfg) -> (image, num_rays) of the chosen engine;
    with a mesh (--sharded), its sharded counterpart."""
    n_real = scene.n_real or None
    if mesh is not None:
        from rays1bench_tpu_torch.parallel.shard import (
            render_image_pallas_sharded, render_image_sharded)
        if args.engine == "plain":
            return lambda spheres, camera, cfg: render_image_sharded(
                spheres, camera, cfg, mesh)
        return lambda spheres, camera, cfg: render_image_pallas_sharded(
            spheres, camera, cfg, mesh, n_real=n_real, respawn=args.respawn)
    if args.engine == "plain":
        from rays1bench_tpu_torch.render.pipeline import render_image
        return render_image
    from rays1bench_tpu_torch.kernels.pipeline import render_image_megakernel
    return lambda spheres, camera, cfg: render_image_megakernel(
        spheres, camera, cfg, n_real=n_real, respawn=args.respawn)


def sharded_mesh(n: int, device="cuda"):
    """(mesh of n ranks, whether this call started the process group): the
    group torchrun started (its environment: RANK, WORLD_SIZE,
    MASTER_ADDR, ...) or one already running; for n = 1 without either, a
    group of one through a file store in a temporary directory. Under NCCL
    each rank takes the card of its LOCAL_RANK."""
    import tempfile

    import torch
    import torch.distributed as dist

    from rays1bench_tpu_torch.parallel.mesh import make_mesh

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    started = not dist.is_initialized()
    if started and "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    elif started and n == 1:
        store = os.path.join(tempfile.mkdtemp(prefix="rays1bench_group_"),
                             "store")
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=0, world_size=1)
    elif started:
        raise SystemExit(f"--sharded {n} runs in a group of {n} ranks: "
                         f"torchrun --nproc-per-node {n} -m "
                         f"rays1bench_tpu_torch.bench.cli --sharded {n} ...")
    if dist.get_world_size() != n:
        raise SystemExit(f"--sharded {n} in a group of "
                         f"{dist.get_world_size()} ranks")
    return make_mesh(n, device=device), started


def main(argv=None):
    args = parse_args(argv)
    import torch

    from rays1bench_tpu_torch.bench import report
    from rays1bench_tpu_torch.bench.profile import smi
    from rays1bench_tpu_torch.runtime import native
    from rays1bench_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        raise SystemExit("rays1bench_tpu_torch.bench.cli needs a CUDA device")
    cfg = config(args)
    mesh, started = sharded_mesh(args.sharded) if args.sharded else \
        (None, False)
    lead = mesh is None or torch.distributed.get_rank() == 0
    try:
        if lead:
            print(f"card: {smi('name', 'power.limit')[0]}", flush=True)
            print(f"native runtime: {native.status()}", flush=True)
            os.makedirs(args.out_dir, exist_ok=True)
        with (profiling.trace(args.profile) if args.profile
              else contextlib.nullcontext()):
            for name in args.scene_names:
                run_scene(args, cfg, name, mesh, lead)
    finally:
        if started:
            torch.distributed.destroy_process_group()
    if not lead:
        return
    if args.profile:
        print(f"profile trace written to {args.profile}", flush=True)
    if args.report:
        for name in args.scene_names:
            recs = report.collect([args.out_dir], name)
            if recs:
                print(f"### {name}\n{report.markdown_table(recs)}\n",
                      flush=True)


def run_scene(args, cfg, name, mesh, lead):
    """Benchmark one scene on every rank; the lead rank writes
    out_<scene>.txt (and .tga) and prints the scene's block."""
    from rays1bench_tpu_torch.bench.harness import (benchmark,
                                                    benchmark_sustained,
                                                    log_results)
    from rays1bench_tpu_torch.render.pipeline import to_srgb_u8
    from rays1bench_tpu_torch.runtime import native
    from rays1bench_tpu_torch.scene import builders

    scene = builders.SCENES[name](cfg.aspect, device="cuda")
    render = render_fn(args, scene, mesh)
    if args.sustained:
        results = [benchmark_sustained(scene, cfg, frames=args.sustained,
                                       num_runs=args.num, render_fn=render)]
    else:
        results = benchmark(scene, cfg, num_runs=args.num, render_fn=render)
    if args.save:
        img, _ = render(scene.spheres,
                        scene.camera.build(scene.spheres.center_x.device),
                        cfg)
        if lead:
            native.tga_write_rgb24(
                os.path.join(args.out_dir, f"out_{name}.tga"),
                to_srgb_u8(img).cpu().numpy())
    if not lead:
        return
    kw = {"version": args.label} if args.label else {}
    log_results(name, results, directory=args.out_dir, **kw)
    r = results[-1]
    print(f"{name}\nelapsed time:\t{r.elapsed_seconds:.3f}s\n"
          f"total rays:\t{r.num_rays}\n"
          f"mrays/s:\t{r.mrays_per_sec:.2f}\n", flush=True)


if __name__ == "__main__":
    main()
