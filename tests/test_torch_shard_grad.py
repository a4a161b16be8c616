"""The port's sharded gradients on the CPU: render_image_mega_sharded (the
fused kernels' plain versions on each rank's ray slice, one all_reduce of
the (10, S) column and camera cotangents) and the mesh= of grad.inverse,
against the JAX package's fused gradient and the port's single-device one.

The port's ranks are four gloo processes (parallel/dryrun.run_ranks); the
JAX side is image_loss through its fused gradient (render_image_mega, its
Pallas kernels in interpret mode) on one device (tests/test_shard.py holds JAX's sharded gradient to it within
1e-4 per column and 1e-3 per camera field). Sizes and parameters are
tests/test_shard.py's: the small scene padded to 8 rows at 48x24 @ 2 spp,
hard at 4 bounces on center_x, radius, albedo_x and fuzz, soft (0.005) at
3 bounces on center_x, center_y and radius with row 0 moved by +0.04.

Tolerances:
- Sharded against the port's single device (the same step on one rank):
  losses equal (the same per-ray math and spp mean), gradients within 1e-4
  of each column's and 1e-3 of each camera field's max abs value
  (tests/test_shard.py's bounds: per-rank partial sums, then the
  all_reduce).
- Against JAX: image loss within 1e-5 relative, gradients within 2e-3 of
  the field's max abs value (tests/test_torch_grad.py's REL_TOL: XLA's
  rsqrt and FMA drift carried through the chain).
- fit_scene(mesh=...): each step's loss equal to the unsharded fit's within
  1e-6 relative, the fitted columns within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rays1bench_tpu.core.config import RenderConfig as JConfig
from rays1bench_tpu.grad import inverse as jinverse
from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu_torch.grad import inverse
from rays1bench_tpu_torch.parallel.dryrun import rank_cases, run_ranks

torch.set_num_threads(1)

HARD = dict(width=48, height=24, spp=2, max_bounces=4, seed=7,
            early_exit=False)
SOFT = dict(HARD, max_bounces=3, soft_silhouette=0.005)
HARD_NAMES = ("center_x", "radius", "albedo_x", "fuzz")
SOFT_NAMES = ("center_x", "center_y", "radius")
COL_TOL, CAM_TOL = 1e-4, 1e-3
REL_TOL, LOSS_TOL = 2e-3, 1e-5
FIT_TOL = 1e-6


def grad_case(cfg, names, engine, bump=0.0, local=False):
    return ("grad", "small", 8, cfg, (4,),
            dict(engine=engine, names=names, bump=bump, local=local))


CASES = [
    ("mega", grad_case(HARD, HARD_NAMES, "mega")),
    ("mega_local", grad_case(HARD, HARD_NAMES, "mega", local=True)),
    ("soft", grad_case(SOFT, SOFT_NAMES, "mega", 0.04)),
    ("soft_local", grad_case(SOFT, SOFT_NAMES, "mega", 0.04, local=True)),
    ("pipeline", grad_case(HARD, HARD_NAMES, "pipeline")),
    ("pipeline_local", grad_case(HARD, HARD_NAMES, "pipeline", local=True)),
    ("fit_mega", ("fit", "small", 8, HARD, (4,),
                  dict(engine="mega", steps=2))),
    ("fit_pipeline", ("fit", "small", 8, HARD, (4,),
                      dict(engine="pipeline", steps=2))),
]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    ranks = run_ranks(rank_cases, 4, str(tmp_path_factory.mktemp("ranks")),
                      [c for _, c in CASES])
    return [dict(zip((n for n, _ in CASES), r)) for r in ranks]


def rel_gap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def jax_grads(kw, names, bump):
    """JAX's image_loss against a 0.3 target through its fused gradient
    (engine "mega": interpret mode on the CPU; under soft silhouettes the
    cross-seed U-statistic, as the port's), with respect to the named
    columns and the camera."""
    cfg = JConfig(**kw)
    scene = jbuilders.create_small_scene(cfg.aspect, pad_multiple=8)
    cam = scene.camera.build()
    p0 = jinverse.params_of(scene.spheres, names)
    p0[names[0]] = p0[names[0]].at[0].add(bump)
    target = jnp.full((cfg.height, cfg.width, 3), 0.3, jnp.float32)
    loss = lambda p, c: jinverse.image_loss(p, scene.spheres, c, target, cfg,
                                            None, "mega")
    return jax.value_and_grad(loss, argnums=(0, 1))(p0, cam)


@pytest.mark.parametrize("case", ["mega", "soft", "pipeline"])
def test_sharded_gradient_equals_the_single_device_port(port, case):
    """Every rank holds the same loss and gradients, those of the same
    step without a mesh up to the order of float sums."""
    loss, g, gc = port[0][case]
    loss1, g1, gc1 = port[0][case + "_local"]
    assert float(loss) == float(loss1)
    for k in g1:
        assert rel_gap(g[k], g1[k]) <= COL_TOL, k
        assert torch.isfinite(g[k]).all()
        assert all(torch.equal(r[case][1][k], g[k]) for r in port), k
    for f in gc1:
        assert rel_gap(gc[f], gc1[f]) <= CAM_TOL, f


@pytest.mark.parametrize("case", ["mega", "soft"])
def test_sharded_fused_gradient_against_jax(port, case):
    kw, names, bump = ((HARD, HARD_NAMES, 0.0) if case == "mega"
                       else (SOFT, SOFT_NAMES, 0.04))
    jloss, (jg, jgc) = jax_grads(kw, names, bump)
    loss, g, gc = port[0][case]
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    for k in names:
        assert rel_gap(g[k], jg[k]) <= REL_TOL, k
    for f in gc:
        assert rel_gap(gc[f], getattr(jgc, f)) <= REL_TOL, f


@pytest.mark.parametrize("engine", ["mega", "pipeline"])
def test_fit_scene_on_a_mesh(port, engine):
    """fit_scene(mesh=...) on four ranks: the same losses and fitted
    columns as the one-process fit, on every rank."""
    from rays1bench_tpu_torch.core.config import RenderConfig
    from rays1bench_tpu_torch.scene import builders

    losses, fitted = port[0][f"fit_{engine}"]
    cfg = RenderConfig(**HARD)
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8,
                                        device="cpu")
    inv = inverse.InverseConfig(steps=2, learning_rate=1e-2,
                                optimize=("albedo_x", "albedo_y", "albedo_z"))
    want, want_losses = inverse.fit_scene(
        scene.spheres, scene.camera.build("cpu"),
        torch.full((cfg.height, cfg.width, 3), 0.3), cfg, inv,
        engine=engine, device="cpu")
    np.testing.assert_allclose(losses, want_losses, rtol=FIT_TOL, atol=0)
    assert float((fitted - want.albedo_x).abs().max()) <= FIT_TOL
    assert all(torch.equal(r[f"fit_{engine}"][1], fitted) for r in port)
    assert losses[1] < losses[0]



@pytest.mark.parametrize("engine", ["mega", "pipeline"])
def test_fits_on_a_submesh_of_one_rank(tmp_path, engine):
    """Two gloo ranks, a mesh of the first alone (parallel.mesh.
    make_submesh): fit_camera and fit_scene through it take two steps
    whose collectives, the gradients' all_reduce included, stay on the
    mesh's group, so the rank outside it takes no part and nothing waits
    for it. The steps equal the one-process fit's (one rank sums
    nothing)."""
    from rays1bench_tpu_torch.core.config import RenderConfig
    from rays1bench_tpu_torch.scene import builders

    cases = [(kind, "small", 8, HARD, (1,), dict(engine=engine, steps=2))
             for kind in ("camera", "fit")]
    ranks = run_ranks(rank_cases, 2, str(tmp_path), cases, timeout=240.0)
    assert ranks[1] == [None, None]
    (cam_losses, lookfrom), (fit_losses, albedo_x) = ranks[0]
    cfg = RenderConfig(**HARD)
    scene = builders.create_small_scene(cfg.aspect, pad_multiple=8,
                                        device="cpu")
    target = torch.full((cfg.height, cfg.width, 3), 0.3)
    want, want_losses = inverse.fit_camera(
        scene.spheres, scene.camera, target, cfg, steps=2, engine=engine,
        device="cpu")
    assert cam_losses == want_losses
    assert torch.equal(lookfrom, want["lookfrom"])
    assert not torch.equal(lookfrom, torch.tensor(scene.camera.lookfrom))
    inv = inverse.InverseConfig(steps=2, learning_rate=1e-2,
                                optimize=("albedo_x", "albedo_y", "albedo_z"))
    fitted, want_losses = inverse.fit_scene(
        scene.spheres, scene.camera.build("cpu"), target, cfg, inv,
        engine=engine, device="cpu")
    assert fit_losses == want_losses and fit_losses[1] < fit_losses[0]
    assert torch.equal(albedo_x, fitted.albedo_x)
