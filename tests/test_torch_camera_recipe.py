"""The JAX package's camera-fit recipe (tests/test_grad.py:514-549) on the
port's grad/inverse.fit_camera, on the CPU: small scene at 64x32 @ 2 spp @
3 b, seed 3, 120 Adam steps toward the true camera's render through the
same engine, held to the JAX test's bars (bench.camfit.CASES).

- vfov moved by 2 degrees at lr 5e-2: the last loss under 20% of the
  first, the vfov error under 0.6 degrees. On both engines (measured:
  "mega" 0.119 and 0.418 degrees, "pipeline" 0.127 and 0.432).
- lookfrom moved by (+0.06, -0.05, +0.04) at lr 5e-3: the last loss under
  5% of the first, the max lookfrom error under 0.015. This half's end is
  chaotic in both packages. The fixed-topology gradient of a camera move
  is dominated at some steps by one grazing primary hit, whose float32
  discriminant keeps two digits. So a start one ulp away ends in another
  basin: the JAX package's own fit, whose recipe start meets the bars,
  misses them from 9 of 25 starts within 2 ulps of it, by as much as
  ratio 2.50 / error 0.228 (PERF.md §6, PR 9). The port's fit follows
  JAX's step for step until the two part (tests/test_torch_camera_fit.py
  pins 20 steps), and from the recipe's start itself it misses. The bars
  are therefore held per fit over the same 25 starts (bench.camfit.
  start_ulps), and more than half must meet both: the JAX package's
  pipeline meets them from 16 of 25, the port's pipeline from 17; on
  "mega" (tests/test_torch_camera_recipe_mega.py) JAX's from 16, missing
  from the recipe's own start (ratio 0.836, error 0.0964), and the
  port's from 16.

Run as a script, `PYTHONPATH=. python tests/test_torch_camera_recipe.py
--jax [--engine pipeline|mega] [--starts 25]` fits the JAX package from
the same starts and prints each start's ratio and error and the count
(its "mega" engine in Pallas interpret mode, ~30 s a fit).
"""

import argparse

import numpy as np
import pytest
import torch

from rays1bench_tpu_torch.bench import camfit
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad import inverse
from rays1bench_tpu_torch.scene import builders

torch.set_num_threads(1)

STEPS = 120
RECIPE = dict(width=64, height=32, spp=2, max_bounces=3, seed=3,
              early_exit=False, ray_chunk=4096)
LOSS_BAR = 0.2          # tests/test_grad.py:548
VFOV_BAR = 0.3 * 2.0    # tests/test_grad.py:549
LF_LOSS_BAR = 0.05      # tests/test_grad.py:541
LF_BAR = 0.25 * 0.06    # tests/test_grad.py:542
STARTS = 25


def recipe(engine):
    """(cfg, scene, target): the recipe's frame and the true camera's
    render through `engine`."""
    cfg = RenderConfig(**RECIPE)
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8,
                                        device="cpu")
    with torch.no_grad():
        target = inverse.render_for_loss(
            scene.spheres, scene.camera.build("cpu"), cfg, engine=engine)
    return cfg, scene, target


def lookfrom_from_most_starts(engine):
    """The lookfrom half from STARTS starts through `engine`: each fit runs
    its 120 steps to finite losses and is held to the JAX bars; more than
    half must meet both."""
    cfg, scene, target = recipe(engine)
    assert camfit.CASES["lookfrom"] == (5e-3, (0.06, -0.05, 0.04),
                                        LF_LOSS_BAR, LF_BAR)
    results = camfit.sweep(scene, target, cfg, "lookfrom", engine, STEPS,
                           "cpu", STARTS)
    assert all(len(r["losses"]) == STEPS and np.isfinite(r["losses"]).all()
               for r in results)
    assert all(r["met"] == (r["ratio"] < LF_LOSS_BAR and r["err"] < LF_BAR)
               for r in results)
    met = sum(r["met"] for r in results)
    assert met > STARTS // 2, [(r["ratio"], r["err"]) for r in results]


@pytest.mark.parametrize("engine", ["mega", "pipeline"])
def test_vfov_recipe_meets_the_jax_bars(engine):
    cfg, scene, target = recipe(engine)
    assert camfit.CASES["vfov"] == (5e-2, 2.0, LOSS_BAR, VFOV_BAR)
    r = camfit.fit(scene, target, cfg, "vfov", engine, STEPS, "cpu")
    assert len(r["losses"]) == STEPS and r["err0"] == 2.0
    assert r["ratio"] < LOSS_BAR, r["losses"]
    assert r["err"] < VFOV_BAR
    assert r["met"]


def test_lookfrom_recipe_meets_the_jax_bars_from_most_starts():
    lookfrom_from_most_starts("pipeline")


def test_camfit_bench_on_the_cpu(capsys):
    """bench.camfit's CLI on a tiny frame through --cpu: both leaves, their
    gradients beside central differences, and the fit's bars; the vfov
    gradient agrees with central differences (no silhouette moves much
    under a 1e-3 degree zoom at this size), and the replay gives the fused
    gradient. --starts fits from that many starts and counts the bars
    met."""
    results = camfit.main(["--cpu", "--width", "16", "--height", "8",
                           "--spp", "1", "--max-bounces", "2", "--steps",
                           "2"])
    assert [r["leaf"] for r in results] == ["lookfrom", "vfov"]
    assert all(len(r["losses"]) == 2 for r in results)
    out = capsys.readouterr().out
    assert "CPU (plain versions; not a device time)" in out
    assert out.count("central differences") == 2
    cfg = RenderConfig(width=16, height=8, spp=1, max_bounces=2, seed=3,
                       early_exit=False)
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8,
                                        device="cpu")
    with torch.no_grad():
        target = inverse.render_for_loss(scene.spheres,
                                         scene.camera.build("cpu"), cfg,
                                         engine="mega")
    start = camfit.moved(scene.camera, "vfov", 2.0)
    fused = camfit.camera_grad(scene.spheres, start, target, cfg)
    replay = camfit.camera_grad(scene.spheres, start, target, cfg,
                                fused=False)
    for a, b in zip(fused[1:], replay[1:]):
        assert torch.allclose(a, b, rtol=1e-5, atol=0)
    swept = camfit.main(["--cpu", "--width", "16", "--height", "8", "--spp",
                         "1", "--max-bounces", "2", "--steps", "2",
                         "--leaf", "lookfrom", "--starts", "3"])
    assert [len(r) for r in swept] == [3]
    out = capsys.readouterr().out
    assert out.count("lookfrom start") == 3 and "of 3 starts" in out
    assert camfit.start_ulps("lookfrom", 3)[0] == (0, 0, 0)
    start = camfit.moved(scene.camera, "lookfrom", (0.06, -0.05, 0.04))
    ulps = camfit.start_ulps("lookfrom", 3)[1]
    got = np.asarray(camfit.nudged(start, "lookfrom", ulps).lookfrom,
                     np.float32)
    want = np.asarray(start.lookfrom, np.float32)
    assert (got.view(np.int32) - want.view(np.int32)).tolist() == list(ulps)


def jax_sweep(engine, starts):
    """The JAX package's fit_camera from the same starts (bench.camfit.
    start_ulps), on the CPU; prints each fit and the count."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from rays1bench_tpu.core.config import RenderConfig as JConfig
    from rays1bench_tpu.grad import inverse as jinverse
    from rays1bench_tpu.scene import builders as jbuilders

    cfg = JConfig(**RECIPE)
    scene = jbuilders.create_small_scene(cfg.aspect, pad_multiple=8)
    spec = scene.camera
    target = jinverse.render_for_loss(scene.spheres, spec.build(), cfg,
                                      engine=engine)
    lr, move, loss_bar, err_bar = camfit.CASES["lookfrom"]
    want = np.asarray(spec.lookfrom, np.float32)
    met = 0
    for ulps in camfit.start_ulps("lookfrom", starts):
        start = camfit.nudged(camfit.moved(spec, "lookfrom", move),
                              "lookfrom", ulps)
        fitted, losses = jinverse.fit_camera(
            scene.spheres, start, target, cfg, learning_rate=lr,
            steps=STEPS, optimize=("lookfrom",), engine=engine)
        ratio = losses[-1] / losses[0]
        err = float(np.abs(np.asarray(fitted["lookfrom"]) - want).max())
        ok = ratio < loss_bar and err < err_bar
        met += ok
        print(f"JAX {engine} lookfrom start {list(ulps)} ulps: loss ratio "
              f"{ratio:.4g}, error {err:.4g}: bars "
              f"{'met' if ok else 'missed'}", flush=True)
    print(f"JAX {engine} lookfrom: {met} of {starts} starts meet both bars",
          flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax", action="store_true", required=True)
    ap.add_argument("--engine", default="pipeline",
                    choices=["pipeline", "mega"])
    ap.add_argument("--starts", type=int, default=STARTS)
    args = ap.parse_args()
    jax_sweep(args.engine, args.starts)
