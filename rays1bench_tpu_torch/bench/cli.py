"""Multi-scene benchmark CLI on one CUDA GPU (rays1bench_tpu/bench/cli.py;
reference: bench.py:10-38, binary flags -w/-n at rayweek1.cpp:943-958).

    python -m rays1bench_tpu_torch.bench.cli [--scenes small,medium,large]
        [--quick] [--save] [--num N] [--spp S] [--max-bounces B]
        [--engine kernel|plain] [--respawn] [--sustained FRAMES]
        [--out-dir DIR] [--label LABEL]

The same flags and defaults as the JAX CLI. The config is the "full"
preset (1280x720 @ 10 spp @ 50 bounces), or "quick" (80x60 @ 4 spp) with
--quick. --engine kernel (the JAX CLI's "pallas", the default) renders
through the one-shot kernel engine, or the respawn engine with --respawn;
--engine plain (the JAX CLI's "xla") through the plain render.pipeline.
render_image on the card. For each scene it writes out_<scene>.txt in the
reference's pipe format (bench.harness.log_results), out_<scene>.tga with
--save, and prints the JAX CLI's per-scene block; the card's name and power
limit come first. Not ported yet, each raising NotImplementedError with its
ROADMAP item: --sharded (parallel/), --profile and --report (the tooling).
Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
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
                    help="not ported: parallel/")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--label", default=None,
                    help="version label written to out_<scene>.txt "
                         "(default: the harness VERSION_NAME)")
    ap.add_argument("--report", action="store_true",
                    help="not ported: the tooling")
    ap.add_argument("--sustained", type=int, default=0, metavar="FRAMES",
                    help="time FRAMES frames queued back to back "
                         "(bench.harness.benchmark_sustained)")
    ap.add_argument("--profile", default="", metavar="LOGDIR",
                    help="not ported: the tooling")
    args = ap.parse_args(argv)
    if args.sharded:
        raise NotImplementedError("--sharded (parallel/) is not ported: "
                                  "ROADMAP.md, queue 1, item 7")
    if args.profile or args.report:
        raise NotImplementedError("--profile and --report (the tooling) are "
                                  "not ported: ROADMAP.md, queue 1, item 8")
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


def render_fn(args, scene):
    """(spheres, camera, cfg) -> (image, num_rays) of the chosen engine."""
    if args.engine == "plain":
        from rays1bench_tpu_torch.render.pipeline import render_image
        return render_image
    from rays1bench_tpu_torch.kernels.pipeline import render_image_megakernel
    return lambda spheres, camera, cfg: render_image_megakernel(
        spheres, camera, cfg, n_real=scene.n_real or None,
        respawn=args.respawn)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from rays1bench_tpu_torch.bench.harness import (benchmark,
                                                    benchmark_sustained,
                                                    log_results)
    from rays1bench_tpu_torch.bench.profile import smi
    from rays1bench_tpu_torch.render.pipeline import to_srgb_u8
    from rays1bench_tpu_torch.scene import builders, tga

    if not torch.cuda.is_available():
        raise SystemExit("rays1bench_tpu_torch.bench.cli needs a CUDA device")
    cfg = config(args)
    print(f"card: {smi('name', 'power.limit')[0]}", flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    for name in args.scene_names:
        scene = builders.SCENES[name](cfg.aspect, device="cuda")
        render = render_fn(args, scene)
        if args.sustained:
            results = [benchmark_sustained(scene, cfg, frames=args.sustained,
                                           num_runs=args.num,
                                           render_fn=render)]
        else:
            results = benchmark(scene, cfg, num_runs=args.num,
                                render_fn=render)
        if args.save:
            img, _ = render(scene.spheres,
                            scene.camera.build(scene.spheres.center_x.device),
                            cfg)
            tga.write_rgb24(os.path.join(args.out_dir, f"out_{name}.tga"),
                            to_srgb_u8(img).cpu().numpy())
        kw = {"version": args.label} if args.label else {}
        log_results(name, results, directory=args.out_dir, **kw)
        r = results[-1]
        print(f"{name}\nelapsed time:\t{r.elapsed_seconds:.3f}s\n"
              f"total rays:\t{r.num_rays}\n"
              f"mrays/s:\t{r.mrays_per_sec:.2f}\n", flush=True)


if __name__ == "__main__":
    main()
