"""Inverse rendering demo on the card (examples/inverse_rendering.py, the
JAX package's; BASELINE.json config 4).

    python -m rays1bench_tpu_torch.examples.inverse_rendering
        [--steps 120] [--lr LR] [--scene small|medium] [--engine E]
        [--checkpoint PATH] [--fit-geometry | --fit-camera] [--cpu]

Perturb a scene, then recover the perturbation by Adam through the
differentiable renderer, fitting to the unperturbed render (rendered
through the same engine). Small scene at 200x100 @ 4 spp @ 10 bounces,
padded to 8 rows:

  (default)       fit the albedos of rows 0 and 1 (x scaled by 1.8 and
                  0.5, y by 0.4 and 1.2), lr 1e-2;
  --fit-geometry  move row 0 by (+0.06, -0.04) in center (x, y) and -0.03
                  in radius, and fit those three on row 0 alone through the
                  soft-silhouette renderer (width 0.005) and the cross-seed
                  U-statistic loss, lr 2e-3, at least 150 steps;
  --fit-camera    move lookfrom by (+0.06, -0.05, +0.04) and fit it
                  (grad/inverse.fit_camera), lr 5e-3, at least 120 steps;
  --scene medium  every real row's albedos times RandomState(11) factors in
                  [0.6, 1.5), all 138 fitted at once.

It runs on the card; --cpu runs the plain versions on the CPU instead.
--engine: "auto" (the fused kernels, "mega", wherever they take the scene),
"mega" or "pipeline" (grad/inverse._pick_engine).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="rays1bench_tpu_torch.examples.inverse_rendering")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--lr", type=float, default=0.0,
                    help="Adam lr (default: 1e-2 albedo, 2e-3 geometry, "
                         "5e-3 camera)")
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions on the CPU")
    ap.add_argument("--checkpoint", default="")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fit-geometry", action="store_true",
                      help="recover a moved and resized sphere through the "
                           "soft-silhouette renderer")
    mode.add_argument("--fit-camera", action="store_true",
                      help="recover a perturbed camera position (lookfrom; "
                           "fitted with vfov it shares the dolly-zoom null "
                           "direction)")
    ap.add_argument("--scene", default="small", choices=["small", "medium"],
                    help="medium: fit all 46 spheres' albedos at once")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "pipeline", "mega"])
    args = ap.parse_args(argv)
    if args.scene == "medium" and (args.fit_geometry or args.fit_camera):
        ap.error("--scene medium fits albedos")
    return args


def errors(name, start, fitted, truth, rows):
    e0 = (getattr(start, name) - getattr(truth, name)).abs()[rows]
    e1 = (getattr(fitted, name) - getattr(truth, name)).abs()[rows]
    return e0.cpu().numpy(), e1.cpu().numpy()


def main(argv=None):
    from rays1bench_tpu_torch.bench.grad import (GEOMETRY, moved_geometry,
                                                 perturb_albedos)
    from rays1bench_tpu_torch.core.config import RenderConfig
    from rays1bench_tpu_torch.grad.inverse import (InverseConfig, fit_camera,
                                                   fit_scene, render_for_loss)
    from rays1bench_tpu_torch.scene import builders

    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu for the plain versions")
    cfg = RenderConfig(width=200, height=100, spp=4, max_bounces=10,
                       early_exit=False, ray_chunk=131072)
    scene = builders.SCENES[args.scene](cfg.aspect, pad_multiple=8,
                                        device=device)
    truth, spec = scene.spheres, scene.camera
    camera = spec.build(device)

    if args.fit_camera:
        with torch.no_grad():
            target = render_for_loss(truth, camera, cfg, engine=args.engine)
        start = dataclasses.replace(spec, lookfrom=(
            spec.lookfrom[0] + 0.06, spec.lookfrom[1] - 0.05,
            spec.lookfrom[2] + 0.04))
        fitted, losses = fit_camera(
            truth, start, target, cfg, learning_rate=args.lr or 5e-3,
            steps=max(args.steps, 120), optimize=("lookfrom",),
            engine=args.engine, verbose=True, device=device)
        print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e}")
        want = np.asarray(spec.lookfrom, np.float32)
        e0 = np.abs(np.asarray(start.lookfrom, np.float32) - want)
        e1 = np.abs(fitted["lookfrom"].cpu().numpy() - want)
        print(f"lookfrom abs error before: {np.round(e0, 4)}  "
              f"after: {np.round(e1, 4)}")
        return losses

    if args.scene == "medium":
        start = perturb_albedos(truth, scene.n_real)
        names = ("albedo_x", "albedo_y", "albedo_z")
        inv = InverseConfig(learning_rate=args.lr or 1e-2, steps=args.steps,
                            optimize=names)
        rows = slice(0, scene.n_real)
    elif args.fit_geometry:
        cfg = cfg.replace(soft_silhouette=0.005)
        start = moved_geometry(truth, "small")
        names = GEOMETRY["small"][2]
        # rows=(0,): fit the sphere known to be off. Without the mask the
        # glass sphere's weakly observed x walks along a flat direction of
        # the loss under Adam's normalization.
        inv = InverseConfig(learning_rate=args.lr or 2e-3,
                            steps=max(args.steps, 150), optimize=names,
                            rows=(0,))
        rows = slice(0, 1)
    else:
        fac = torch.ones((2, truth.count), device=device)
        fac[:, :2] = torch.tensor([[1.8, 0.5], [0.4, 1.2]], device=device)
        start = dataclasses.replace(truth, albedo_x=truth.albedo_x * fac[0],
                                    albedo_y=truth.albedo_y * fac[1])
        names = ("albedo_x", "albedo_y")
        inv = InverseConfig(learning_rate=args.lr or 1e-2, steps=args.steps,
                            optimize=names)
        rows = slice(0, 3)
    with torch.no_grad():
        target = render_for_loss(truth, camera, cfg, engine=args.engine)
    fitted, losses = fit_scene(start, camera, target, cfg, inv, verbose=True,
                               checkpoint_path=args.checkpoint or None,
                               engine=args.engine, device=device)
    print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e} "
          f"({losses[0] / max(losses[-1], 1e-12):.0f}x reduction)")
    for name in names:
        e0, e1 = errors(name, start, fitted, truth, rows)
        if args.scene == "medium":
            print(f"{name:9s} mean abs error over {scene.n_real} spheres: "
                  f"{e0.mean():.4f} -> {e1.mean():.4f}")
        else:
            print(f"{name:9s} abs error before: {np.round(e0, 4)}  "
                  f"after: {np.round(e1, 4)}")
    return losses


if __name__ == "__main__":
    main()
