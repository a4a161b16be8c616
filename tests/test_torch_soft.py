"""Parity of the port's soft-silhouette gradient path with the JAX package on
the CPU: the near-miss promotion and the soft hit record
(render/intersect), the soft plain render (render/pipeline.render_image),
the soft topology forward's plain version (kernels/megakernel.
trace_topology_reference, through kernels/pipeline.render_image_topology)
against render_image_pallas_topology in Pallas interpret mode, the soft
fused backward's plain version (kernels/mega_backward.backward_reference)
against backward_pallas in interpret mode and against the port's own soft
pipeline gradient, and the cross-seed U-statistic loss (grad/inverse.
image_loss). Also: the respawn and wavefront engines refuse the soft mode.

Inputs are made once from numpy: the small scene (hollow glass, fuzzed
metal, dielectric) padded to 8 rows at 64x32 @ 2 spp @ 4 bounces, seed 7,
soft_silhouette 0.005: tests/test_grad.py:659-661's configuration.

Tolerances and why:
- _near_miss_index is eager IEEE float32 on both sides (no rsqrt, no
  sigmoid): rows and flags equal. In the soft hit record every field is
  bit-exact but the normals, renormalized with XLA's rsqrt there and IEEE
  1/sqrt here (<= 3 ulp, the scatter bound of tests/test_torch_core.py),
  and cover, where jax.nn.sigmoid and the port's float64 sigmoid round
  differently: <= 2 ulp on hit lanes (measured 1-2); a miss lane's cover
  belongs to a far row and is masked by hit.
- One ulp of cover can flip take = u < cover and send a lane down the
  other branch, so whole renders meet ROADMAP's bounds: relative ray-count
  gap <= 2e-3, image mean abs gap <= 1e-3. Measured: equal ray counts
  (7,327) and every topology plane equal, image mean abs gap 1.8e-8.
- Gradients: per column and per ray plane within 2e-3 of the column's max
  abs value (tests/test_grad.py:390's bound), except the raw inv_radius
  column: the soft normal is renormalized, so its exact derivative with
  respect to inv_radius is 0 and the column holds only the rounding of a
  cancellation (a different rounding in each package). It enters the
  radius gradient times -1/r^2, so the gradients of the scene's own columns,
  chained through scene/spheres.prepare, are held to the same bound.
  Measured against backward_pallas: worst column 1.25e-3 (center_x), ray
  planes <= 5.1e-4, radius (chained) 2.9e-4; the raw inv_radius column
  0.22 apart.
- The soft fused gradient against the soft pipeline gradient: 0.02, the
  JAX package's own bound between the two (tests/test_grad.py:690-694);
  measured <= 8.0e-4. The replay backward equals the fused one's plain
  version exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rays1bench_tpu.core.config import RenderConfig as JConfig
from rays1bench_tpu.grad import inverse as jinverse
from rays1bench_tpu.kernels import mega_backward as jmb
from rays1bench_tpu.kernels import pipeline as jkpipeline
from rays1bench_tpu.render import intersect as jintersect
from rays1bench_tpu.render import pipeline as jpipeline
from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu.scene import spheres as jspheres
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad import inverse
from rays1bench_tpu_torch.grad.mega import render_image_mega
from rays1bench_tpu_torch.kernels import mega_backward, megakernel
from rays1bench_tpu_torch.kernels import pipeline as tkpipeline
from rays1bench_tpu_torch.render import intersect as tintersect
from rays1bench_tpu_torch.render import pipeline as tpipeline
from rays1bench_tpu_torch.render.pipeline import primary_rays_from_ids
from rays1bench_tpu_torch.scene import convert
from rays1bench_tpu_torch.scene import spheres as tspheres
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS

torch.set_num_threads(1)

KW = dict(width=64, height=32, spp=2, max_bounces=4, seed=7,
          early_exit=False, soft_silhouette=0.005)
RAY_TOL = 2e-3
IMG_TOL = 1e-3
TOPO_SHARE = 1e-3
REL_TOL = 2e-3
PIPE_TOL = 0.02
GEOMETRY = ("center_x", "center_y", "radius")
SOA_FLOATS = tuple(c for c in COLUMNS if c != "mat_type")


def leaves(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def ulp_diff(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def rel_gap(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@functools.cache
def case():
    """numpy inputs and the JAX side's soft topology forward and fused
    backward (interpret mode)."""
    jcfg, cfg = JConfig(ray_chunk=8192, **KW), RenderConfig(**KW)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    jcam = jscene.camera.build()
    soa = convert.soa_from_numpy(leaves(jscene.spheres, COLUMNS), "cpu")
    cam = convert.camera_from_numpy(leaves(jcam, convert.CAMERA_FIELDS),
                                    "cpu")
    jimg, jn, jtopo = jkpipeline.render_image_pallas_topology(
        jscene.spheres, jcam, jcfg, interpret=True)
    rid = tkpipeline.frame_ray_ids(cfg, "cpu")
    rays = [r.numpy() for r in primary_rays_from_ids(cam, cfg, rid)]
    cts = np.random.default_rng(4).uniform(-0.5, 0.5, (3, rid.shape[0]))
    cts = cts.astype(np.float32)
    jprep = jspheres.prepare(jscene.spheres)
    jgrads, jray_cts = jmb.backward_pallas(
        jprep, *map(jnp.asarray, rays), jnp.asarray(rid.numpy()),
        *map(jnp.asarray, cts), jtopo, jcfg, tile_rays=2048,
        n_rays=cfg.num_primary_rays, interpret=True)
    return dict(jcfg=jcfg, cfg=cfg, jscene=jscene, jcam=jcam, soa=soa,
                cam=cam, prep=tspheres.prepare(soa), rid=rid, rays=rays,
                cts=cts, n_real=jscene.n_real, j_img=np.asarray(jimg),
                j_rays=int(jn), j_topo=np.array(jtopo),
                j_grads=np.asarray(jgrads),
                j_ray_cts=np.stack([np.asarray(v) for v in jray_cts]))


def random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = ((r.random((3, n)) * 2 - 1) * 4).astype(np.float32)
    o[1] = np.abs(o[1]) + 0.3
    d = r.standard_normal((3, n))
    return o, (d / np.linalg.norm(d, axis=0)).astype(np.float32)


@pytest.mark.parametrize("scene,eps", [("small", 0.005), ("medium", 0.05)])
def test_near_miss_and_soft_hit_record_match_jax(scene, eps):
    """Random rays about the scene, each ray's hard winner from the plain
    sweep, the same inputs to both packages; promote=True."""
    jsoa = jbuilders.SCENES[scene](16 / 9, pad_multiple=8).spheres
    jprep = jspheres.prepare(jsoa)
    prep = tspheres.prepare(convert.soa_from_numpy(leaves(jsoa, COLUMNS),
                                                   "cpu"))
    o, d = random_rays(20_000, 1)
    t = torch.from_numpy
    best, hit = tintersect.closest_hit_index(*map(t, (*o, *d)), prep, 1e-3,
                                             3.4e38)
    jargs = (*map(jnp.asarray, (*o, *d)), jprep)
    jbest, jhit = jnp.asarray(best.numpy().astype(np.int32)), \
        jnp.asarray(hit.numpy())
    j_near, near = tintersect._near_miss_index(*map(t, (*o, *d)), prep, hit,
                                               best, 1e-3, eps)
    jj, jnear = jintersect._near_miss_index(*jargs, jhit, jbest, 1e-3, eps)
    assert np.array_equal(near.numpy(), np.asarray(jnear))
    assert np.array_equal(j_near.numpy(), np.asarray(jj))
    assert int(near.sum()) > 50

    want = jintersect.hit_record_from_index(*jargs, jbest, jhit, 1e-3,
                                            soft_eps=eps)
    got = tintersect.hit_record_from_index(*map(t, (*o, *d)), prep, best, hit,
                                           1e-3, soft_eps=eps)
    assert isinstance(got, tintersect.SoftHitRecord)
    on_hit = got.hit.numpy()
    assert np.array_equal(on_hit, np.asarray(want.hit))
    for f in dataclasses.fields(got):
        w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name).numpy()
        assert g.dtype == w.dtype, f.name
        if f.name in ("nx", "ny", "nz"):
            assert ulp_diff(g, w).max() <= 3, f.name
        elif f.name == "cover":
            assert ulp_diff(g[on_hit], w[on_hit]).max() <= 2
        else:
            assert np.array_equal(g, w), f.name


def test_soft_render_matches_jax():
    """The soft plain render (plain sweep + promotion, two-branch draw)
    against the JAX XLA soft render; with the index sweep (the gradient
    path's cfg.pallas_intersect) the port's image and rays are unchanged."""
    c = case()
    want, n_want = jpipeline.render_image(c["jscene"].spheres, c["jcam"],
                                          c["jcfg"])
    got, n_got = tpipeline.render_image(c["soa"], c["cam"], c["cfg"])
    assert abs(int(n_got) - int(n_want)) <= RAY_TOL * int(n_want)
    assert np.abs(got.numpy() - np.asarray(want)).mean() <= IMG_TOL
    idx, n_idx = tpipeline.render_image(
        c["soa"], c["cam"], c["cfg"].replace(pallas_intersect=True))
    assert torch.equal(idx, got) and int(n_idx) == int(n_got)
    hard, _ = tpipeline.render_image(c["soa"], c["cam"],
                                     c["cfg"].replace(soft_silhouette=0.0))
    assert not torch.equal(hard, got)


def test_soft_topology_forward_matches_jax():
    """render_image_topology (the plain version of the soft one-shot kernel
    on the CPU) against render_image_pallas_topology(interpret=True):
    topology planes, ray counts and image; both packages promote some
    lanes and pass some through."""
    c = case()
    img, n, topo = tkpipeline.render_image_topology(c["soa"], c["cam"],
                                                    c["cfg"])
    assert (topo.numpy() != c["j_topo"]).mean() <= TOPO_SHARE
    assert abs(int(n) - c["j_rays"]) <= RAY_TOL * c["j_rays"]
    assert np.abs(img.numpy() - c["j_img"]).mean() <= IMG_TOL
    stats = {}
    t = torch.from_numpy
    packed = megakernel.pack_spheres(c["prep"])
    rad, cnt, topo2 = megakernel.trace_topology_reference(
        packed, *map(t, c["rays"]), c["rid"], c["cfg"], stats=stats)
    assert torch.equal(topo2, topo) and int(cnt.sum()) == int(n)
    assert stats["promoted"] > 0 and stats["pass_through"] > 0
    # The soft forward's topology differs from the hard one's.
    _, _, hard = megakernel.trace_topology_reference(
        packed, *map(t, c["rays"]), c["rid"],
        c["cfg"].replace(soft_silhouette=0.0))
    assert not torch.equal(hard, topo)


def soa_grads(soa, grads):
    """Chain prepared-column cotangents (GRAD_ROWS order) onto the scene's
    float columns through scene/spheres.prepare."""
    soa = dataclasses.replace(soa, **{
        c: getattr(soa, c).clone().requires_grad_(True) for c in SOA_FLOATS})
    prep = tspheres.prepare(soa)
    torch.autograd.backward(
        [getattr(prep, n) for n in mega_backward.GRAD_ROWS],
        [torch.from_numpy(np.array(g)) for g in grads])
    return {c: getattr(soa, c).grad.numpy() for c in SOA_FLOATS}


def test_soft_backward_reference_matches_jax():
    """backward_reference against backward_pallas(interpret=True) on the
    same rays, ids, cotangents and the JAX soft topology."""
    c = case()
    t = torch.from_numpy
    grads, ray_cts = mega_backward.backward_reference(
        c["prep"], *map(t, c["rays"]), c["rid"], *map(t, c["cts"]),
        t(c["j_topo"]), c["cfg"])
    g = grads.numpy()
    for k, name in enumerate(mega_backward.GRAD_ROWS):
        if name != "inv_radius":
            assert rel_gap(g[k], c["j_grads"][k]) <= REL_TOL, name
    for k in range(6):
        assert rel_gap(ray_cts[k].numpy(), c["j_ray_cts"][k]) <= REL_TOL, k
    got, want = soa_grads(c["soa"], g), soa_grads(c["soa"], c["j_grads"])
    for name in SOA_FLOATS:
        assert rel_gap(got[name], want[name]) <= REL_TOL, name
    assert np.abs(g[:, c["n_real"]:]).max() == 0.0
    assert np.isfinite(g).all() and all(torch.isfinite(r).all()
                                        for r in ray_cts)


def test_soft_mega_gradient_matches_pipeline():
    """The soft gradient three ways on the port, as tests/test_grad.py:647
    holds the JAX package: the fused backward's plain version
    (render_image_mega, fused) and the replay backward (fused=False) at the
    promoted topology, against the soft pipeline (render_image with the
    index sweep, promotion in plain torch)."""
    c = case()
    params0 = inverse.params_of(c["soa"], GEOMETRY)
    with torch.no_grad():
        params0["center_x"][0] += 0.04
        params0["radius"][0] -= 0.02

    def grads(render):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params0.items()}
        img = render(inverse.with_params(c["soa"], params))
        torch.mean((img - 0.3) ** 2).backward()
        return {k: v.grad.numpy() for k, v in params.items()}

    cfg = inverse._grad_cfg(c["cfg"])
    gp = grads(lambda s: tpipeline.render_image(s, c["cam"], cfg)[0])
    gf = grads(lambda s: render_image_mega(s, c["cam"], cfg)[0])
    gr = grads(lambda s: render_image_mega(s, c["cam"], cfg, fused=False)[0])
    for k in GEOMETRY:
        assert rel_gap(gf[k], gp[k]) < PIPE_TOL, k
        assert rel_gap(gr[k], gf[k]) <= REL_TOL, k
        assert np.abs(gf[k]).max() > 0, k


def test_image_loss_u_statistic_matches_jax():
    """image_loss under soft silhouettes: the cross-seed U-statistic's value
    and its gradients on the pipeline engine, against the JAX package's, at
    32x16 @ 2 spp @ 3 b from a moved and resized sphere; and the port's
    value is mean((imgA - target) * (imgB - target)) with imgB at seed +
    101."""
    kw = dict(KW, width=32, height=16, max_bounces=3)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    jcam = jscene.camera.build()
    soa = convert.soa_from_numpy(leaves(jscene.spheres, COLUMNS), "cpu")
    cam = convert.camera_from_numpy(leaves(jcam, convert.CAMERA_FIELDS),
                                    "cpu")
    target = np.random.default_rng(5).uniform(0.2, 0.8, (16, 32, 3))
    target = target.astype(np.float32)
    jp = jinverse.params_of(jscene.spheres, GEOMETRY)
    jp["center_x"] = jp["center_x"].at[0].add(0.06)
    jp["center_y"] = jp["center_y"].at[0].add(-0.04)
    jp["radius"] = jp["radius"].at[0].add(-0.03)
    jloss, jgrads = jax.value_and_grad(jinverse.image_loss)(
        jp, jscene.spheres, jcam, jnp.asarray(target), jcfg, None,
        "pipeline")
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in jp.items()}
    tt = torch.from_numpy(target)
    loss = inverse.image_loss(params, soa, cam, tt, cfg, engine="pipeline")
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    for k in GEOMETRY:
        assert rel_gap(params[k].grad.numpy(), np.asarray(jgrads[k])) \
            <= REL_TOL, k
    with torch.no_grad():
        sph = inverse.with_params(soa, params)
        a = inverse.render_for_loss(sph, cam, cfg, engine="pipeline")
        b = inverse.render_for_loss(sph, cam, cfg.replace(seed=cfg.seed + 101),
                                    engine="pipeline")
    assert not torch.equal(a, b)
    assert loss.item() == float(torch.mean((a - tt) * (b - tt)))


def test_respawn_and_wavefront_refuse_soft():
    c = case()
    packed = megakernel.pack_spheres(c["prep"])
    cfg = c["cfg"]
    with pytest.raises(ValueError, match="respawn engine is the hard"):
        megakernel.trace_respawn(packed, megakernel.pack_camera(c["cam"]), cfg)
    rays = [torch.from_numpy(r) for r in c["rays"]]
    with pytest.raises(ValueError, match="wavefront engine is the hard"):
        megakernel.trace_wavefront(packed, *rays, c["rid"], cfg)
    with pytest.raises(ValueError, match="respawn engine is the hard"):
        tkpipeline.render_image_megakernel(c["soa"], c["cam"], cfg)
    # The one-shot engine takes it: the soft kernel's plain version.
    img, n = tkpipeline.render_image_megakernel(c["soa"], c["cam"], cfg,
                                                respawn=False)
    assert int(n) > cfg.num_primary_rays and torch.isfinite(img).all()
