"""Parity of the port's engine="pipeline" gradient with the JAX package's on
the CPU: render/pipeline.render_image with cfg.pallas_intersect (the
closest-hit index sweep, then the hit record rebuilt from its rows), its
gradients through grad.inverse.image_loss, three Adam steps of fit_scene,
remat, and engine="auto" routing.

JAX's Pallas index kernel runs in interpret mode (its pipeline picks that on
the CPU). Tolerances and why:
- Image: the pinned whole-render bounds (ROADMAP.md), ray count relative
  gap <= 2e-3 and image mean abs gap <= 1e-3: XLA's rsqrt and jitted FMA
  contraction move a few paths (measured at 64x32 @ 2 @ 5: equal ray
  counts, mean abs gap 2.4e-8 small, 6.1e-7 medium).
- Gradients on the center, radius and albedo columns: max abs gap <= 2e-3
  of the column's max abs value, the bound of tests/test_torch_grad.py
  (measured worst 2.8e-4, radius).
- Fit: losses within LOSS_TOL relative, params within PARAM_TOL absolute
  (against a 1e-2 step), as tests/test_torch_grad.py holds the mega fit.
- Within the port, bit for bit: the index kernel's plain version or the
  plain sweep as the intersector, and remat on or off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rays1bench_tpu.core.config import RenderConfig as JConfig
from rays1bench_tpu.grad import inverse as jinverse
from rays1bench_tpu.render import pipeline as jpipeline
from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad import inverse
from rays1bench_tpu_torch.kernels import intersect_index
from rays1bench_tpu_torch.render import pipeline as tpipeline
from rays1bench_tpu_torch.scene import builders as tbuilders
from rays1bench_tpu_torch.scene import convert
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS

torch.set_num_threads(1)

RAY_TOL = 2e-3
IMG_TOL = 1e-3
REL_TOL = 2e-3
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
GRAD_COLUMNS = ("center_x", "center_y", "radius", "albedo_x", "albedo_z")
ALBEDOS = ("albedo_x", "albedo_y", "albedo_z")


def leaves(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def port_scene(jscene, jcam):
    return (convert.soa_from_numpy(leaves(jscene.spheres, COLUMNS), "cpu"),
            convert.camera_from_numpy(leaves(jcam, convert.CAMERA_FIELDS),
                                      "cpu"))


def rel_gap(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("name", ["small", "medium"])
def test_render_matches_jax(name):
    kw = dict(width=64, height=32, spp=2, max_bounces=5, seed=9,
              early_exit=False, pallas_intersect=True)
    jscene = jbuilders.SCENES[name](16 / 9, pad_multiple=8)
    jcam = jscene.camera.build()
    want, n_want = jpipeline.render_image(jscene.spheres, jcam, JConfig(**kw))
    soa, cam = port_scene(jscene, jcam)
    cfg = RenderConfig(**kw)
    got, n_got = tpipeline.render_image(soa, cam, cfg)
    assert abs(int(n_got) - int(n_want)) <= RAY_TOL * int(n_want)
    assert np.abs(got.numpy() - np.asarray(want)).mean() <= IMG_TOL
    plain, n_plain = tpipeline.render_image(
        soa, cam, cfg.replace(pallas_intersect=False))
    assert torch.equal(plain, got) and int(n_plain) == int(n_got)


def test_gradients_match_jax():
    kw = dict(width=48, height=32, spp=2, max_bounces=4, seed=5)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    jcam = jscene.camera.build()
    p0 = jinverse.params_of(jscene.spheres, GRAD_COLUMNS)
    p0["center_x"] = p0["center_x"].at[0].add(0.04)
    p0["radius"] = p0["radius"].at[0].add(-0.02)
    target = jnp.full((32, 48, 3), 0.3, jnp.float32)
    jg = jax.grad(jinverse.image_loss)(p0, jscene.spheres, jcam, target,
                                       jcfg, engine="pipeline")

    soa, cam = port_scene(jscene, jcam)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in p0.items()}
    inverse.image_loss(params, soa, cam, torch.from_numpy(np.array(target)),
                       cfg, engine="pipeline").backward()
    for k in GRAD_COLUMNS:
        g = params[k].grad.numpy()
        assert rel_gap(g, np.asarray(jg[k])) <= REL_TOL, k
        assert np.isfinite(g).all() and np.abs(g[jscene.n_real:]).max() == 0


def test_fit_matches_optax():
    """Three Adam steps on the albedos from the medium-fit perturbation, the
    target rendered through the pipeline on each side."""
    kw = dict(width=32, height=16, spp=2, max_bounces=3, seed=5)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    jcam = jscene.camera.build()
    target = jinverse.render_for_loss(jscene.spheres, jcam, jcfg,
                                      engine="pipeline")
    fac = 0.6 + 0.9 * np.random.RandomState(11).rand(3, jscene.spheres.count)
    fac[:, jscene.n_real:] = 1.0
    pert = dataclasses.replace(jscene.spheres, **{
        c: jnp.clip(getattr(jscene.spheres, c) * fac[k], 0, 1)
        for k, c in enumerate(ALBEDOS)})
    jfitted, jlosses = jinverse.fit_scene(
        pert, jcam, target, jcfg,
        jinverse.InverseConfig(learning_rate=1e-2, steps=3,
                               optimize=ALBEDOS), engine="pipeline")

    soa, cam = port_scene(dataclasses.replace(jscene, spheres=pert), jcam)
    fitted, losses = inverse.fit_scene(
        soa, cam, torch.from_numpy(np.array(target)), cfg,
        inverse.InverseConfig(learning_rate=1e-2, steps=3, optimize=ALBEDOS),
        engine="pipeline", device="cpu")
    assert losses[-1] < losses[0]
    assert np.allclose(losses, jlosses, rtol=LOSS_TOL, atol=0)
    for c in ALBEDOS:
        assert np.abs(getattr(fitted, c).numpy()
                      - np.asarray(getattr(jfitted, c))).max() <= PARAM_TOL


def test_remat_is_exact_and_the_backward_never_sweeps(monkeypatch):
    """Four chunks: with and without remat the image and gradients are
    equal bit for bit, the sweep runs once a bounce of each chunk in the
    forward, and never in the backward."""
    cfg = RenderConfig(width=32, height=16, spp=2, max_bounces=4, seed=3,
                       early_exit=False, pallas_intersect=True,
                       ray_chunk=256)
    scene = tbuilders.create_medium_scene(cfg.aspect, pad_multiple=8,
                                          device="cpu")
    cam = scene.camera.build("cpu")
    calls = []
    sweep = intersect_index.closest_hit_index
    monkeypatch.setattr(intersect_index, "closest_hit_index",
                        lambda *a: calls.append(1) or sweep(*a))
    out = []
    for remat in (False, True):
        params = inverse.params_of(scene.spheres, GRAD_COLUMNS)
        calls.clear()
        img, n = tpipeline.render_image(
            inverse.with_params(scene.spheres, params), cam, cfg, remat=remat)
        forward = len(calls)
        torch.mean((img - 0.3) ** 2).backward()
        assert len(calls) == forward == 4 * (cfg.max_bounces + 1)
        out.append((img, int(n), {k: v.grad for k, v in params.items()}))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]
    for k in GRAD_COLUMNS:
        assert torch.equal(out[0][2][k], out[1][2][k]), k
        assert out[0][2][k].abs().max() > 0, k


def test_auto_routes_to_the_pipeline_where_the_fused_backward_cannot():
    cfg = RenderConfig(width=8, height=4, spp=1, max_bounces=2)
    small = tbuilders.create_small_scene(2.0, pad_multiple=8, device="cpu")
    pick = lambda soa, c, engine="auto": inverse._pick_engine(soa, c, engine)
    assert pick(small.spheres, cfg) == "mega"
    assert pick(small.spheres, cfg.replace(max_bounces=51)) == "pipeline"
    assert pick(small.spheres, cfg, "pipeline") == "pipeline"
    big = tbuilders.create_small_scene(2.0, pad_multiple=2756, device="cpu")
    assert big.spheres.count == 2756
    assert pick(big.spheres, cfg) == "pipeline"
    with pytest.raises(ValueError, match="supported"):
        pick(big.spheres, cfg, "mega")
    with pytest.raises(ValueError, match="unknown engine"):
        pick(small.spheres, cfg, "xla")
    assert inverse._grad_cfg(cfg).pallas_intersect is True
    assert inverse._grad_cfg(cfg.replace(pallas_intersect=False)) \
        .pallas_intersect is False
