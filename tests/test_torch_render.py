"""Parity of rays1bench_tpu_torch.render with rays1bench_tpu.render on the
CPU, on inputs made with numpy from a seed and fed to both packages.

Bit-exact: the closest-hit winner and its record, the sky, the u8 tonemap.
Within a few ulp: generate_rays and scatter, whose normalizations take
XLA's rsqrt on the JAX side (see test_torch_core.py). Measured on 20k
inputs: ray directions at most 2 ulp apart (~30% at 1, ~5% at 2); scatter
directions at most 3 (one in 20k; one ulp of the rsqrt factor can be two
of the product). The plain image
pipeline, the port's CPU oracle, is held against the JAX XLA pipeline,
which runs jitted and so contracts multiply-adds into FMAs: its ray count
and image carry a small stated drift.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rays1bench_tpu.core.config import RenderConfig as JConfig
from rays1bench_tpu.render import integrator as jintegrator
from rays1bench_tpu.render import intersect as jintersect
from rays1bench_tpu.render import materials as jmaterials
from rays1bench_tpu.render import pipeline as jpipeline
from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu.scene import spheres as jspheres
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.render import integrator as tintegrator
from rays1bench_tpu_torch.render import intersect as tintersect
from rays1bench_tpu_torch.render import materials as tmaterials
from rays1bench_tpu_torch.render import pipeline as tpipeline
from rays1bench_tpu_torch.scene import builders as tbuilders
from rays1bench_tpu_torch.scene import spheres as tspheres

torch.set_num_threads(1)

ASPECT = 1280 / 720
N = 20_000
SEED = 10001


def ulp_diff(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def both(*arrays):
    """The same numpy arrays as (jax arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def random_rays(seed, n=N, spread=6.0):
    """Origins in a box above the ground, unit directions (numpy float32)."""
    r = np.random.default_rng(seed)
    o = (r.random((3, n)) * 2 - 1) * spread
    o[1] = np.abs(o[1]) + 0.2
    d = r.standard_normal((3, n))
    d /= np.linalg.norm(d, axis=0)
    return [x.astype(np.float32) for x in (*o, *d)]


def indexed_scenes(name):
    """Both packages' prepared spheres for a scene, with each row's fuzz
    replaced by its row index, so a hit record's fuzz names the winner."""
    j = jspheres.prepare(jbuilders.SCENES[name](ASPECT).spheres)
    t = tspheres.prepare(tbuilders.SCENES[name](ASPECT, device="cpu").spheres)
    idx = np.arange(j.count, dtype=np.float32)
    return (dataclasses.replace(j, fuzz=jnp.asarray(idx)),
            dataclasses.replace(t, fuzz=torch.from_numpy(idx)))


@pytest.mark.parametrize("name", ["small", "medium", "large"])
def test_closest_hit_bit_exact(name):
    jsph, tsph = indexed_scenes(name)
    jr, tr = both(*random_rays(1))
    want = jintersect.closest_hit(*jr, jsph, 1e-3, 3.4e38)
    got = tintersect.closest_hit(*tr, tsph, 1e-3, 3.4e38)
    hit = np.asarray(want.hit)
    assert 0.05 < hit.mean() < 0.95
    assert np.array_equal(got.hit.numpy(), hit)
    for f in ("fuzz", "t", "px", "py", "pz", "nx", "ny", "nz", "mat_type",
              "albedo_x", "albedo_y", "albedo_z", "ref_idx"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f


@pytest.mark.parametrize("name", ["small", "large"])
def test_generate_rays_within_2ulp(name):
    spec = jbuilders.SCENES[name](ASPECT).camera
    r = np.random.default_rng(2)
    s, t = r.random((2, N)).astype(np.float32)
    rid = r.integers(0, 2**31 - 1, N).astype(np.int32)
    want = spec.build().generate_rays(jnp.asarray(s), jnp.asarray(t),
                                      jnp.uint32(SEED), jnp.asarray(rid))
    got = tbuilders.SCENES[name](ASPECT, device="cpu").camera.build(
        "cpu").generate_rays(
        torch.from_numpy(s), torch.from_numpy(t), SEED, torch.from_numpy(rid))
    for k, (w, g) in enumerate(zip(want, got)):
        d = ulp_diff(np.asarray(w), g.numpy())
        # origins carry no rsqrt: exact; directions within 2 ulp.
        assert d.max() <= (0 if k < 3 else 2), (k, np.bincount(d))


def random_hit_records(seed, n=N):
    """One fixed set of hit records: unit normals, half of them facing the
    incoming ray (entering glass) and half not, every material, fuzz in
    [0, 1), ref_idx in [1.2, 2.4] and albedos in [0, 1]."""
    r = np.random.default_rng(seed)
    d = r.standard_normal((3, n))
    d /= np.linalg.norm(d, axis=0)
    nrm = r.standard_normal((3, n))
    nrm /= np.linalg.norm(nrm, axis=0)
    p = r.standard_normal((3, n))
    f32 = lambda a: np.asarray(a, np.float32)
    cols = dict(
        hit=np.ones(n, bool), t=f32(r.random(n)),
        px=f32(p[0]), py=f32(p[1]), pz=f32(p[2]),
        nx=f32(nrm[0]), ny=f32(nrm[1]), nz=f32(nrm[2]),
        mat_type=r.integers(0, 3, n).astype(np.int32),
        albedo_x=f32(r.random(n)), albedo_y=f32(r.random(n)),
        albedo_z=f32(r.random(n)), fuzz=f32(r.random(n)),
        ref_idx=f32(1.2 + 1.2 * r.random(n)))
    return [f32(x) for x in d], cols


@pytest.mark.parametrize("bounce", [0, 3])
def test_scatter_within_3ulp(bounce):
    d, cols = random_hit_records(3)
    rid = np.random.default_rng(4).integers(0, 2**31 - 1, N).astype(np.int32)
    jrec = jintersect.HitRecord(**{k: jnp.asarray(v) for k, v in cols.items()})
    trec = tintersect.HitRecord(**{k: torch.from_numpy(v)
                                   for k, v in cols.items()})
    (jd, ja, jok) = jmaterials.scatter(*map(jnp.asarray, d), jrec,
                                       jnp.uint32(SEED), jnp.asarray(rid),
                                       jnp.int32(bounce))
    (td, ta, tok) = tmaterials.scatter(*map(torch.from_numpy, d), trec,
                                       SEED, torch.from_numpy(rid), bounce)
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert 0.1 < np.asarray(jok).mean() < 1.0
    for w, g in zip(ja, ta):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for w, g in zip(jd, td):
        d_ulp = ulp_diff(np.asarray(w), g.numpy())
        assert d_ulp.max() <= 3, np.bincount(d_ulp)


def test_sky_color_bit_exact():
    dy = np.random.default_rng(5).uniform(-1, 1, N).astype(np.float32)
    want = jintegrator.sky_color(None, jnp.asarray(dy), None)
    got = tintegrator.sky_color(None, torch.from_numpy(dy), None)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_to_srgb_u8_bit_exact():
    img = np.random.default_rng(6).uniform(-0.2, 1.2, (16, 24, 3))
    img = img.astype(np.float32)
    img[0, 0] = [0.0, 1.0, np.nextafter(np.float32(1), 0)]
    want = np.asarray(jpipeline.to_srgb_u8(jnp.asarray(img)))
    got = tpipeline.to_srgb_u8(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_trace_inactive_lanes_never_count():
    tsph = tspheres.prepare(
        tbuilders.create_small_scene(ASPECT, device="cpu").spheres)
    rays = [torch.from_numpy(a) for a in random_rays(7, n=512, spread=1.0)]
    rid = torch.arange(512, dtype=torch.int32)
    active = rid % 3 != 0
    (rr, rg, rb), cnt = tintegrator.trace(tsph, *rays, SEED, rid,
                                          max_bounces=5, active=active)
    assert (cnt[~active] == 0).all() and (rr[~active] == 0).all()
    assert (cnt[active] >= 1).all() and (cnt <= 6).all()


# Plain image pipeline vs the JAX XLA pipeline (jitted: FMA-contracted on
# XLA:CPU). Measured: small 14,691 rays on both sides, image mean abs gap
# 1.6e-8; medium 9,584 vs 9,585 (one path an ulp sent elsewhere, relative
# gap 1.0e-4), mean abs gap 4.7e-5. Pinned: count gap <= 2e-3 relative,
# image mean abs gap <= 1e-3.
@pytest.mark.parametrize("name,spp", [("small", 4), ("medium", 2)])
def test_render_image_matches_jax_xla(name, spp):
    kw = dict(width=64, height=32, spp=spp, max_bounces=6, seed=11)
    jcfg, tcfg = JConfig(**kw), RenderConfig(**kw)
    jscene = jbuilders.SCENES[name](jcfg.aspect)
    want, n_want = jpipeline.render_image(jscene.spheres,
                                          jscene.camera.build(), jcfg)
    tscene = tbuilders.SCENES[name](tcfg.aspect, device="cpu")
    got, n_got = tpipeline.render_image(tscene.spheres,
                                        tscene.camera.build("cpu"), tcfg)
    n_want, n_got = int(n_want), int(n_got)
    assert abs(n_got - n_want) <= 2e-3 * n_want, (n_got, n_want)
    gap = np.abs(got.numpy() - np.asarray(want))
    assert gap.mean() <= 1e-3, gap.mean()
    assert got.shape == (32, 64, 3) and torch.isfinite(got).all()


def test_render_scene_chunks_do_not_change_the_image():
    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=4)
    scene = tbuilders.create_small_scene(cfg.aspect, device="cpu")
    a, na = tpipeline.render_scene(scene, cfg)
    b, nb = tpipeline.render_scene(scene, cfg.replace(ray_chunk=40))
    assert na == nb and torch.equal(a, b)
