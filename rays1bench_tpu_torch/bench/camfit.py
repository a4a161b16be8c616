"""The camera fit's recipe, timed and checked (grad/inverse.fit_camera).

    python -m rays1bench_tpu_torch.bench.camfit [--width 1280] [--height 720]
        [--spp 4] [--max-bounces 10] [--seed 3] [--soft EPS]
        [--engine mega|pipeline] [--steps 120] [--leaf lookfrom,vfov]
        [--starts N] [--cpu]

The JAX package's recipe (tests/test_grad.py:514-549) on the small scene
(8 rows): from the true camera moved by CASES (lookfrom by (+0.06, -0.05,
+0.04) at lr 5e-3; vfov by 2 degrees at lr 5e-2), `--steps` Adam steps
toward the true camera's render through the same engine, with --soft the
soft-silhouette renderer. For each leaf it prints the loss's gradient in
the leaf at the moved start beside central differences of the loss, the
last loss over the first and the leaf's error against the JAX test's bars,
the fit's seconds and the warm step's ms on the host clock (a loss read
each step). It runs on the card; --cpu runs the plain versions (no time
printed then is a device time).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad import inverse, mega
from rays1bench_tpu_torch.render.camera import build_camera

# leaf: (lr, move from the true camera, loss bar: last over first, error
# bar: max abs leaf error), tests/test_grad.py:531-549.
CASES = {"lookfrom": (5e-3, (0.06, -0.05, 0.04), 0.05, 0.015),
         "vfov": (5e-2, 2.0, 0.2, 0.6)}


def moved(spec, leaf, move):
    """The CameraSpec with its `leaf` (lookfrom or vfov) moved by `move`."""
    if leaf == "vfov":
        return dataclasses.replace(spec, vfov=spec.vfov + move)
    return dataclasses.replace(spec, lookfrom=tuple(
        a + d for a, d in zip(spec.lookfrom, move)))


def start_ulps(leaf, n, seed=0):
    """n ulp offsets for `leaf`'s float32 coordinates (3 for lookfrom, 1 for
    vfov): none first, then each coordinate's drawn from -2..2 by numpy's
    default_rng(seed)."""
    size = 1 if leaf == "vfov" else 3
    rng = np.random.default_rng(seed)
    return [(0,) * size] + [tuple(int(u) for u in rng.integers(-2, 3, size))
                            for _ in range(n - 1)]


def nudged(spec, leaf, ulps):
    """The camera spec (either package's) with each float32 coordinate of
    `leaf` moved by its whole number of ulps (np.nextafter)."""
    v = np.atleast_1d(np.asarray(getattr(spec, leaf), np.float32)).copy()
    for k, n in enumerate(ulps):
        for _ in range(abs(n)):
            v[k] = np.nextafter(v[k], np.float32(np.inf if n > 0 else -np.inf))
    vals = tuple(float(x) for x in v)
    return dataclasses.replace(spec, **{leaf: vals[0] if leaf == "vfov"
                                        else vals})


def camera_grad(spheres, spec, target, cfg, engine="mega", fused=True):
    """(loss, gradient in lookfrom, gradient in vfov) of the MSE between the
    render through build_camera(spec) and target. engine "mega" with
    fused=False differentiates the replay (render_image_mega's reference
    path) instead of kernel B."""
    device = spheres.center_x.device
    lf = torch.tensor(spec.lookfrom, dtype=torch.float32, device=device,
                      requires_grad=True)
    vf = torch.tensor(spec.vfov, dtype=torch.float32, device=device,
                      requires_grad=True)
    cam = build_camera(lf, spec.lookat, spec.vup, vf, spec.aspect,
                       spec.aperture, spec.focus_dist)
    if engine == "mega":
        img, _ = mega.render_image_mega(spheres, cam, inverse._grad_cfg(cfg),
                                        fused=fused)
    else:
        img = inverse.render_for_loss(spheres, cam, cfg, engine=engine)
    loss = torch.mean((img - target) ** 2)
    loss.backward()
    return float(loss.detach()), lf.grad, vf.grad


def central_differences(spheres, spec, target, cfg, engine, leaf,
                        eps=1e-3):
    """Central differences of the loss in each coordinate of `leaf`."""
    def loss(k, sign):
        if leaf == "vfov":
            sp = moved(spec, "vfov", sign * eps)
        else:
            d = [0.0, 0.0, 0.0]
            d[k] = sign * eps
            sp = moved(spec, "lookfrom", d)
        with torch.no_grad():
            img = inverse.render_for_loss(
                spheres, sp.build(spheres.center_x.device), cfg,
                engine=engine)
            return float(torch.mean((img - target) ** 2))
    return [(loss(k, 1) - loss(k, -1)) / (2 * eps)
            for k in range(1 if leaf == "vfov" else 3)]


def fit(scene, target, cfg, leaf, engine, steps, device, ulps=None):
    """One recipe fit from the moved camera, its coordinates then moved by
    `ulps` (nudged) if given: a dict of the losses, the leaf's error before
    and after, the ratio and whether both bars are met, and the wall
    seconds (synchronized)."""
    lr, move, loss_bar, err_bar = CASES[leaf]
    spec = scene.camera
    start = moved(spec, leaf, move)
    if ulps is not None:
        start = nudged(start, leaf, ulps)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fitted, losses = inverse.fit_camera(
        scene.spheres, start, target, cfg, learning_rate=lr, steps=steps,
        optimize=(leaf,), engine=engine, device=device)
    sync()
    seconds = time.perf_counter() - t0
    want = np.asarray(getattr(spec, leaf), np.float32)
    err0 = float(np.abs(np.asarray(getattr(start, leaf), np.float32)
                        - want).max())
    err = float(np.abs(fitted[leaf].cpu().numpy() - want).max())
    ratio = losses[-1] / losses[0]
    return dict(leaf=leaf, lr=lr, move=move, losses=losses, err0=err0,
                err=err, ratio=ratio, seconds=seconds,
                met=ratio < loss_bar and err < err_bar,
                bars=(loss_bar, err_bar), fitted=fitted)


def step_ms(scene, spec, target, cfg, engine, device, steps=10):
    """The warm camera step's ms on the host clock (two steps first)."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    inverse.fit_camera(scene.spheres, spec, target, cfg, steps=2,
                       engine=engine, device=device)
    sync()
    t0 = time.perf_counter()
    inverse.fit_camera(scene.spheres, spec, target, cfg, steps=steps,
                       engine=engine, device=device)
    sync()
    return (time.perf_counter() - t0) * 1e3 / steps


def main(argv=None):
    from rays1bench_tpu_torch.bench.profile import smi
    from rays1bench_tpu_torch.scene import builders

    ap = argparse.ArgumentParser(prog="rays1bench_tpu_torch.bench.camfit")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-bounces", type=int, default=10)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--soft", type=float, default=0.0)
    ap.add_argument("--engine", default="mega", choices=["mega", "pipeline"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--leaf", default="lookfrom,vfov")
    ap.add_argument("--starts", type=int, default=1,
                    help="fit from this many starts within 2 ulps of the "
                         "recipe's (start_ulps) and count the bars met")
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu for the plain versions")
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_bounces=args.max_bounces, seed=args.seed,
                       early_exit=False, soft_silhouette=args.soft)
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8,
                                        device=device)
    with torch.no_grad():
        target = inverse.render_for_loss(scene.spheres,
                                         scene.camera.build(device), cfg,
                                         engine=args.engine)
    where = smi("name", "power.limit")[0] if device == "cuda" else \
        "CPU (plain versions; not a device time)"
    print(f"camfit small {args.width}x{args.height} @ {args.spp} spp @ "
          f"{args.max_bounces} b, seed {args.seed}, "
          f"{f'soft {args.soft}' if args.soft else 'hard'}, {args.engine}: "
          f"{where}", flush=True)
    if args.starts > 1:
        return [sweep(scene, target, cfg, leaf, args.engine, args.steps,
                      device, args.starts)
                for leaf in args.leaf.split(",")]
    results = []
    for leaf in args.leaf.split(","):
        start = moved(scene.camera, leaf, CASES[leaf][1])
        _, g_lf, g_vf = camera_grad(scene.spheres, start, target, cfg,
                                    args.engine)
        grad = g_vf.reshape(1) if leaf == "vfov" else g_lf
        fd = central_differences(scene.spheres, start, target, cfg,
                                 args.engine, leaf)
        r = fit(scene, target, cfg, leaf, args.engine, args.steps, device)
        ms = step_ms(scene, start, target, cfg, args.engine, device)
        print(f"{leaf}: gradient at the moved start "
              f"{[f'{g:.4e}' for g in grad.tolist()]}, central differences "
              f"{[f'{g:.4e}' for g in fd]}; {args.steps} steps in "
              f"{r['seconds']:.2f} s, warm step {ms:.2f} ms; loss "
              f"{r['losses'][0]:.4e} -> {r['losses'][-1]:.4e} (ratio "
              f"{r['ratio']:.4f}, bar {r['bars'][0]}), error {r['err0']:.4f}"
              f" -> {r['err']:.4f} (bar {r['bars'][1]}): bars "
              f"{'met' if r['met'] else 'missed'}", flush=True)
        results.append(r)
    return results


def sweep(scene, target, cfg, leaf, engine, steps, device, n):
    """--starts: the recipe's fit of `leaf` from n starts (start_ulps);
    prints each and the count that meets both bars. Returns the fits'
    results."""
    results = []
    for ulps in start_ulps(leaf, n):
        r = fit(scene, target, cfg, leaf, engine, steps, device, ulps)
        print(f"{leaf} start {list(ulps)} ulps: loss ratio {r['ratio']:.4g}"
              f", error {r['err']:.4g}: bars "
              f"{'met' if r['met'] else 'missed'} ({r['seconds']:.2f} s)",
              flush=True)
        results.append(r)
    print(f"{leaf}: {sum(r['met'] for r in results)} of {n} "
          f"starts meet both bars {CASES[leaf][2:]}", flush=True)
    return results


if __name__ == "__main__":
    main()
