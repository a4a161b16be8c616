"""Parity of the gradient path's kernel modules with the JAX package on the
CPU: the topology replay (render/intersect.hit_record_from_index,
render/integrator.trace(topology=...), render/pipeline.render_image(
topology=...)), the topology forward (kernels/megakernel.
trace_topology_reference against trace_pallas(emit_topology=True) in Pallas
interpret mode), and the fused backward's plain version
(kernels/mega_backward.backward_reference against backward_pallas in
interpret mode).

Inputs are made once per case from numpy: the small scene (hollow glass,
fuzzed metal, dielectric) padded to 8 rows at 64x32 @ 2 spp, seed 7, at
max_bounces 3 and 5 as tests/test_grad.py runs them. The same scene leaves,
rays, ray ids, cotangents and topology go to both packages.

Tolerances and why:
- hit_record_from_index is eager IEEE float32 on both sides: bit-exact.
- The replayed trace, the replayed image and the topology forward meet
  jitted XLA:CPU (FMA contraction) and XLA's rsqrt on the JAX side, so a
  path may end elsewhere: the render slice's pinned bounds hold
  (tests/test_torch_render.py), ray-count gap <= 2e-3
  relative and radiance mean abs gap <= 1e-3. Measured at mb 3 / 5: equal
  ray counts (7,151 / 7,340), radiance mean abs gap 1.8e-8 / 2.0e-8, and
  every topology plane equal on every lane; pinned: at most TOPO_SHARE of
  the lanes may differ.
- backward_reference against backward_pallas: per column and per ray plane
  max abs gap <= 2e-3 of the column's max abs value, the JAX package's own
  fused-vs-replay bound (tests/test_grad.py:390). Measured worst: 1.5e-4
  (center_y, mb 3) and 8.6e-4 (center_y, mb 5), ray planes <= 3.6e-4. The
  gap is rsqrt and FMA drift amplified through the chain. Placeholder rows
  get exactly 0, and no value is NaN.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rays1bench_tpu.core.config import RenderConfig as JConfig
from rays1bench_tpu.kernels import mega_backward as jmb
from rays1bench_tpu.kernels import megakernel as jmega
from rays1bench_tpu.render import integrator as jintegrator
from rays1bench_tpu.render import intersect as jintersect
from rays1bench_tpu.render import pipeline as jpipeline
from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu.scene import spheres as jspheres
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import mega_backward, megakernel
from rays1bench_tpu_torch.kernels.pipeline import ray_coords
from rays1bench_tpu_torch.render import integrator as tintegrator
from rays1bench_tpu_torch.render import intersect as tintersect
from rays1bench_tpu_torch.render import pipeline as tpipeline
from rays1bench_tpu_torch.render.pipeline import primary_rays
from rays1bench_tpu_torch.scene import convert
from rays1bench_tpu_torch.scene import spheres as tspheres
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS

torch.set_num_threads(1)

KW = dict(width=64, height=32, spp=2, seed=7, early_exit=False)
RAY_TOL = 2e-3
IMG_TOL = 1e-3
TOPO_SHARE = 1e-3
REL_TOL = 2e-3


def leaves(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


@functools.cache
def case(mb):
    """numpy inputs and the JAX side's outputs for one max_bounces."""
    jcfg = JConfig(max_bounces=mb, ray_chunk=2048, **KW)
    cfg = RenderConfig(max_bounces=mb, **KW)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    jcam = jscene.camera.build()
    soa = convert.soa_from_numpy(leaves(jscene.spheres, COLUMNS), "cpu")
    cam = convert.camera_from_numpy(leaves(jcam, convert.CAMERA_FIELDS), "cpu")
    rid, x, y = ray_coords(cfg, "cpu")
    rays = [r.numpy() for r in primary_rays(cam, cfg, x, y, rid)]
    jprep = jspheres.prepare(jscene.spheres)
    (jrr, jrg, jrb), jn, jtopo = jmega.trace_pallas(
        jprep, *map(jnp.asarray, rays), jnp.asarray(rid.numpy()), jcfg,
        tile_rays=2048, sync_every=3, interpret=True, emit_topology=True)
    cts = np.random.default_rng(mb).uniform(-0.5, 0.5, (3, rid.shape[0]))
    cts = cts.astype(np.float32)
    jgrads, jray_cts = jmb.backward_pallas(
        jprep, *map(jnp.asarray, rays), jnp.asarray(rid.numpy()),
        *map(jnp.asarray, cts), jtopo, jcfg, tile_rays=2048,
        n_rays=cfg.num_primary_rays, interpret=True)
    return dict(
        jcfg=jcfg, cfg=cfg, jscene=jscene, jcam=jcam, soa=soa, cam=cam,
        jprep=jprep, prep=tspheres.prepare(soa), rid=rid, rays=rays,
        cts=cts, n_real=jscene.n_real,
        j_rad=np.stack([np.asarray(v) for v in (jrr, jrg, jrb)]),
        j_rays=int(jn), j_topo=np.array(jtopo),
        j_grads=np.asarray(jgrads),
        j_ray_cts=np.stack([np.asarray(v) for v in jray_cts]))


def rel_gap(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def rad_gap(rad, want):
    return np.abs(np.stack([r.numpy() for r in rad]) - want).mean()


@pytest.mark.parametrize("scene,pad", [("small", 8), ("large", 128)])
def test_hit_record_from_index_bit_exact(scene, pad):
    """Eager IEEE on both sides; rows -1 (dead lanes, read as row 0) and
    placeholder rows included; the large scene's 512 rows take the JAX
    gather, the small scene's 8 its select sweep."""
    jsoa = jbuilders.SCENES[scene](16 / 9, pad_multiple=pad).spheres
    jprep = jspheres.prepare(jsoa)
    prep = tspheres.prepare(convert.soa_from_numpy(leaves(jsoa, COLUMNS),
                                                   "cpu"))
    r = np.random.default_rng(1)
    n = 5000
    o = ((r.random((3, n)) * 2 - 1) * 4).astype(np.float32)
    d = r.standard_normal((3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    best = r.integers(-1, jprep.count, n).astype(np.int32)
    hit = best >= 0
    want = jintersect.hit_record_from_index(
        *map(jnp.asarray, (*o, *d)), jprep, jnp.asarray(best),
        jnp.asarray(hit), 1e-3)
    got = tintersect.hit_record_from_index(
        *map(torch.from_numpy, (*o, *d)), prep, torch.from_numpy(best),
        torch.from_numpy(hit), 1e-3)
    for f in dataclasses.fields(got):
        w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f.name


@pytest.mark.parametrize("mb", [3, 5])
def test_trace_replay_matches_jax(mb):
    """integrator.trace(early_exit=False, topology=...) on the JAX
    topology, against the JAX integrator's replay."""
    c = case(mb)
    topo = c["j_topo"]
    rid = c["rid"].numpy()
    (jr, jg, jb), jn = jintegrator.trace(
        c["jprep"], *map(jnp.asarray, c["rays"]), jnp.uint32(c["cfg"].seed),
        jnp.asarray(rid), max_bounces=mb, early_exit=False,
        topology=(jnp.asarray(topo), jnp.asarray(topo >= 0)))
    t_topo = torch.from_numpy(topo)
    rad, cnt = tintegrator.trace(
        c["prep"], *map(torch.from_numpy, c["rays"]), c["cfg"].seed,
        c["rid"], max_bounces=mb, early_exit=False,
        topology=(t_topo, t_topo >= 0))
    n_want, n_got = int(jn), int(cnt.sum())
    assert abs(n_got - n_want) <= RAY_TOL * n_want, (n_got, n_want)
    want = np.stack([np.asarray(v) for v in (jr, jg, jb)])
    assert rad_gap(rad, want) <= IMG_TOL
    with pytest.raises(ValueError, match="fixed-trip"):
        tintegrator.trace(c["prep"], *map(torch.from_numpy, c["rays"]), 7,
                          c["rid"], max_bounces=mb,
                          topology=(t_topo, t_topo >= 0))


def test_render_image_replay_matches_jax():
    """render_image(topology=...) in ray-id order, against the JAX replay
    render on the JAX topology; both chunk the rays (2048 a chunk)."""
    c = case(3)
    want, n_want = jpipeline.render_image(c["jscene"].spheres, c["jcam"],
                                          c["jcfg"], topology=c["j_topo"])
    got, n_got = tpipeline.render_image(
        c["soa"], c["cam"], c["cfg"].replace(ray_chunk=2048),
        topology=torch.from_numpy(c["j_topo"]))
    n_want, n_got = int(n_want), int(n_got)
    assert abs(n_got - n_want) <= RAY_TOL * n_want, (n_got, n_want)
    assert np.abs(got.numpy() - np.asarray(want)).mean() <= IMG_TOL
    assert got.shape == (32, 64, 3) and torch.isfinite(got).all()


@pytest.mark.parametrize("mb", [3, 5])
def test_topology_forward_matches_jax(mb):
    """trace_topology_reference against trace_pallas(emit_topology=True) in
    interpret mode on the same rays. The JAX kernel runs with sync_every=3,
    so at mb=3 its bounce batches overshoot past max_bounces: the guarded
    write must leave the depth-capped lanes' last plane intact
    (tests/test_grad.py:312-326), and the port must agree there too."""
    c = case(mb)
    t = torch.from_numpy
    (rr, rg, rb), cnt, topo = megakernel.trace_topology_reference(
        megakernel.pack_spheres(c["prep"]), *map(t, c["rays"]), c["rid"],
        c["cfg"])
    assert topo.shape == (mb + 1, c["rid"].shape[0])
    assert (topo.numpy() != c["j_topo"]).mean() <= TOPO_SHARE
    assert (topo[mb] >= 0).any()
    n_got = int(cnt.sum())
    assert abs(n_got - c["j_rays"]) <= RAY_TOL * c["j_rays"]
    assert rad_gap((rr, rg, rb), c["j_rad"]) <= IMG_TOL
    # A dead lane stays -1 on every later plane.
    dead = topo[:-1] < 0
    assert not (dead & (topo[1:] >= 0)).any()


@pytest.mark.parametrize("mb", [3, 5])
def test_backward_reference_matches_jax(mb):
    """backward_reference against backward_pallas(interpret=True) on
    identical prepared spheres, rays, ids, cotangents and topology."""
    c = case(mb)
    t = torch.from_numpy
    grads, ray_cts = mega_backward.backward_reference(
        c["prep"], *map(t, c["rays"]), c["rid"], *map(t, c["cts"]),
        t(c["j_topo"]), c["cfg"])
    assert grads.shape == (mega_backward.NUM_GRAD, 8)
    for k, name in enumerate(mega_backward.GRAD_ROWS):
        assert rel_gap(grads[k].numpy(), c["j_grads"][k]) <= REL_TOL, name
    for k in range(6):
        assert rel_gap(ray_cts[k].numpy(), c["j_ray_cts"][k]) <= REL_TOL, k
    assert np.abs(grads.numpy()[:, c["n_real"]:]).max() == 0.0
    assert torch.isfinite(grads).all()
    assert all(torch.isfinite(r).all() for r in ray_cts)


def test_backward_reference_when_every_ray_misses():
    """A list of rays that all miss at their first bounce (a chunk of sky):
    the origins reach no radiance, so their cotangents are exactly 0 and
    the columns' too; the directions' equal the whole list's at those rays
    bit for bit (per-ray math does not depend on the other rays)."""
    c = case(3)
    t = torch.from_numpy
    topo = t(c["j_topo"])
    rays = [t(r) for r in c["rays"]]
    cts = [t(x) for x in c["cts"]]
    _, full = mega_backward.backward_reference(
        c["prep"], *rays, c["rid"], *cts, topo, c["cfg"])
    sky = (topo[0] < 0).nonzero()[:, 0]
    assert 0 < sky.numel() < c["rid"].numel()
    grads, ray_cts = mega_backward.backward_reference(
        c["prep"], *(r[sky] for r in rays), c["rid"][sky],
        *(x[sky] for x in cts), topo[:, sky], c["cfg"])
    assert (grads == 0).all() and all((g == 0).all() for g in ray_cts[:3])
    assert any((g != 0).any() for g in ray_cts[3:])
    for got, want in zip(ray_cts[3:], full[3:]):
        assert torch.equal(got, want[sky])


def test_trace_topology_on_cpu_runs_the_plain_version():
    c = case(3)
    t = torch.from_numpy
    packed = megakernel.pack_spheres(c["prep"])
    before = megakernel.ONESHOT_LAUNCHES
    rad, cnt, total, topo = megakernel.trace_topology(
        packed, *map(t, c["rays"]), c["rid"], c["cfg"])
    assert megakernel.ONESHOT_LAUNCHES == before
    ref_rad, ref_cnt, ref_topo = megakernel.trace_topology_reference(
        packed, *map(t, c["rays"]), c["rid"], c["cfg"])
    assert torch.equal(topo, ref_topo) and torch.equal(cnt, ref_cnt)
    assert all(torch.equal(a, b) for a, b in zip(rad, ref_rad))
    assert total.dtype == torch.int64 and int(total) == int(cnt.sum())
    rays = [t(r) for r in c["rays"]]
    with pytest.raises(ValueError):
        megakernel.trace_topology(packed, *rays[:5], rays[5][:-1], c["rid"],
                                  c["cfg"])
    with pytest.raises(ValueError):
        megakernel.trace_topology(packed, *rays, c["rid"].long(), c["cfg"])


def test_padding_lanes_never_traced():
    """Ray ids at or above num_primary_rays are padding: never counted,
    topology -1, zero radiance and zero cotangents."""
    c = case(3)
    t = torch.from_numpy
    rid = c["rid"].clone()
    rid[::5] = c["cfg"].num_primary_rays
    rays = [t(r) for r in c["rays"]]
    packed = megakernel.pack_spheres(c["prep"])
    rad, cnt, topo = megakernel.trace_topology_reference(packed, *rays, rid,
                                                         c["cfg"])
    pad = rid >= c["cfg"].num_primary_rays
    assert (cnt[pad] == 0).all() and (topo[:, pad] == -1).all()
    assert all((r[pad] == 0).all() for r in rad)
    _, ray_cts = mega_backward.backward(
        c["prep"], *rays, rid, *map(t, c["cts"]), topo, c["cfg"])
    assert all((g[pad] == 0).all() for g in ray_cts)


def test_backward_on_cpu_runs_the_plain_version_and_checks_inputs():
    c = case(3)
    t = torch.from_numpy
    rays = [t(r) for r in c["rays"]]
    args = (c["prep"], *rays, c["rid"], *map(t, c["cts"]), t(c["j_topo"]))
    before = mega_backward.LAUNCHES
    grads, cts = mega_backward.backward(*args, c["cfg"])
    assert mega_backward.LAUNCHES == before
    ref, ref_cts = mega_backward.backward_reference(*args, c["cfg"])
    assert torch.equal(grads, ref)
    assert all(torch.equal(a, b) for a, b in zip(cts, ref_cts))
    with pytest.raises(ValueError, match="topo"):
        mega_backward.backward(*args[:-1], t(c["j_topo"][:-1]), c["cfg"])
    with pytest.raises(ValueError, match="ct_r"):
        mega_backward.backward(*args[:8], args[8].double(), *args[9:],
                               c["cfg"])


def test_supported_states_the_kernel_limits():
    cfg = RenderConfig(max_bounces=10)
    assert mega_backward.supported(512, cfg)
    assert mega_backward.supported(2755, cfg)
    assert not mega_backward.supported(2756, cfg)
    assert mega_backward.supported(48, cfg.replace(max_bounces=50))
    assert not mega_backward.supported(48, cfg.replace(max_bounces=51))
