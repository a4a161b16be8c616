"""Parity of the port's one-shot and wavefront engines (rays1bench_tpu_torch.
kernels.megakernel.trace_oneshot / trace_wavefront, kernels/pipeline.
render_image_megakernel(respawn=False)) with the JAX package on the CPU.

- trace_wavefront_reference against trace_pallas_wavefront(interpret=True)
  on the same rays (small scene, hollow glass, 64x32 @ 2 spp): the ray
  total equal, and each ray's count equal to the JAX one-shot kernel's
  (trace_pallas(debug_iters=True), which the JAX wavefront equals per ray);
  radiance within the topology forward's bound
  (tests/test_torch_grad_replay.py): mean abs gap <= 1e-3, the drift of
  XLA's rsqrt and jitted FMA contraction (measured equal counts and a gap
  of ~2e-8).
- Within the port, the wavefront's plain version against the one-shot's
  (trace_topology_reference) bit for bit, for several schedules at max
  bounces 6 and 3 (the budget runs out before the schedule does).
- The one-shot engine against render_image_pallas(respawn=False) in
  interpret mode within the pinned whole-render bounds (ray count relative
  gap <= 2e-3, image mean abs gap <= 1e-3); against the port's respawn
  engine, the ray count equal and the image within float addition order.

The CUDA kernels themselves run only on a GPU: see tests/test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rays1bench_tpu.core.config import RenderConfig as JConfig
from rays1bench_tpu.kernels import megakernel as jmega
from rays1bench_tpu.kernels import pipeline as jpipeline
from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu.scene import spheres as jspheres
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import megakernel
from rays1bench_tpu_torch.kernels import pipeline as tpipeline
from rays1bench_tpu_torch.render.pipeline import primary_rays_from_ids
from rays1bench_tpu_torch.scene import builders as tbuilders
from rays1bench_tpu_torch.scene import convert
from rays1bench_tpu_torch.scene import spheres as tspheres
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS

torch.set_num_threads(1)

RAY_TOL = 2e-3
IMG_TOL = 1e-3
SUM_ORDER_TOL = 1e-5


def leaves(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


@functools.cache
def jax_case(mb):
    """Rays of the small scene at 64x32 @ 2 spp in ray-id order, and the
    JAX wavefront and one-shot kernels' results on them."""
    kw = dict(width=64, height=32, spp=2, max_bounces=mb, seed=7)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    cam = convert.camera_from_numpy(
        leaves(jscene.camera.build(), convert.CAMERA_FIELDS), "cpu")
    rid = tpipeline.frame_ray_ids(cfg, "cpu")
    rays = [r.numpy() for r in primary_rays_from_ids(cam, cfg, rid)]
    jprep = jspheres.prepare(jscene.spheres)
    jargs = (jprep, *map(jnp.asarray, rays), jnp.asarray(rid.numpy()), jcfg)
    (wr, wg, wb), w_total = jmega.trace_pallas_wavefront(
        *jargs, tile_rays=1024, unroll=4, schedule=(2, 3, 6), interpret=True)
    _, _, _, j_cnt = jmega.trace_pallas(*jargs, tile_rays=1024,
                                        interpret=True, debug_iters=True)
    soa = convert.soa_from_numpy(leaves(jscene.spheres, COLUMNS), "cpu")
    return dict(cfg=cfg, rid=rid, rays=[torch.from_numpy(r) for r in rays],
                packed=megakernel.pack_spheres(tspheres.prepare(soa)),
                j_rad=np.stack([np.asarray(v) for v in (wr, wg, wb)]),
                j_total=int(w_total), j_cnt=np.asarray(j_cnt))


@pytest.mark.parametrize("mb", [6, 3])
def test_wavefront_reference_matches_jax(mb):
    c = jax_case(mb)
    rad, cnt, total = megakernel.trace_wavefront_reference(
        c["packed"], *c["rays"], c["rid"], c["cfg"], (2, 3, 6))
    assert int(total) == c["j_total"] == int(c["j_cnt"].sum())
    assert np.array_equal(cnt.numpy(), c["j_cnt"])
    gap = np.abs(np.stack([r.numpy() for r in rad]) - c["j_rad"]).mean()
    assert gap <= IMG_TOL


@functools.cache
def port_case(mb):
    cfg = RenderConfig(width=40, height=24, spp=4, max_bounces=mb, seed=3)
    scene = tbuilders.create_small_scene(cfg.aspect, pad_multiple=8,
                                         device="cpu")
    rid = tpipeline.frame_ray_ids(cfg, "cpu")
    rays = primary_rays_from_ids(scene.camera.build("cpu"), cfg, rid)
    packed = megakernel.pack_spheres(tspheres.prepare(scene.spheres))
    rad, cnt, _ = megakernel.trace_topology_reference(packed, *rays, rid,
                                                      cfg)
    return cfg, packed, rays, rid, rad, cnt


@pytest.mark.parametrize("mb", [6, 3])
@pytest.mark.parametrize("schedule", [(2, 5), (2, 3, 6), (1,), (4, 7)])
def test_wavefront_equals_oneshot_bit_for_bit(schedule, mb):
    cfg, packed, rays, rid, want_rad, want_cnt = port_case(mb)
    rad, cnt, total = megakernel.trace_wavefront_reference(
        packed, *rays, rid, cfg, schedule)
    assert torch.equal(cnt, want_cnt) and int(total) == int(want_cnt.sum())
    assert all(torch.equal(a, b) for a, b in zip(rad, want_rad))


def test_schedule_rules_match_jax():
    """The JAX schedule: the budget clamps to max_bounces+1, phases past it
    do not run, the last phase runs to max_bounces+1."""
    spans = megakernel.wavefront_spans
    assert spans((2, 3, 6), 50) == [(0, 2), (2, 5), (5, 51)]
    assert spans((2, 3, 6), 3) == [(0, 2), (2, 4)]
    assert spans((2, 5), 6) == [(0, 2), (2, 7)]
    assert spans((1,), 6) == [(0, 7)]
    assert spans((4, 7), 3) == [(0, 4)]
    for bad in ((), (2, 0)):
        with pytest.raises(ValueError, match="schedule"):
            spans(bad, 6)


def test_wrappers_on_cpu_run_the_plain_versions():
    cfg, packed, rays, rid, want_rad, want_cnt = port_case(6)
    rays = [r.contiguous() for r in rays]
    before = (megakernel.ONESHOT_LAUNCHES, megakernel.PHASE_LAUNCHES)
    rad, cnt, total = megakernel.trace_oneshot(packed, *rays, rid, cfg)
    w_rad, w_cnt, w_total = megakernel.trace_wavefront(packed, *rays, rid,
                                                       cfg, (2, 5))
    assert (megakernel.ONESHOT_LAUNCHES, megakernel.PHASE_LAUNCHES) == before
    for got, n in ((rad, cnt), (w_rad, w_cnt)):
        assert torch.equal(n, want_cnt)
        assert all(torch.equal(a, b) for a, b in zip(got, want_rad))
    assert int(total) == int(w_total) == int(want_cnt.sum())
    state, alive, cnt0 = megakernel.wavefront_state(*rays, rid, cfg)
    with pytest.raises(ValueError, match="slots"):
        megakernel.wavefront_phase(packed, state, alive, rid, cnt0,
                                   torch.arange(3), 0, 2, cfg)
    with pytest.raises(ValueError, match="state"):
        megakernel.wavefront_phase(packed, state[:11], alive, rid, cnt0,
                                   None, 0, 2, cfg)


@pytest.mark.parametrize("name,spp", [("small", 4), ("medium", 2)])
def test_oneshot_engine_matches_jax_interpret(name, spp, monkeypatch):
    kw = dict(width=64, height=32, spp=spp, max_bounces=6, seed=11)
    jcfg = JConfig(**kw)
    jscene = jbuilders.SCENES[name](jcfg.aspect)
    jcam = jscene.camera.build()
    monkeypatch.setattr(jpipeline, "trace_pallas", functools.partial(
        jmega.trace_pallas, interpret=True))
    jpipeline._render_jit._clear_cache()
    try:
        want, n_want = jpipeline.render_image_pallas(
            jscene.spheres, jcam, jcfg, tile_rays=1024, unroll=4,
            n_real=jscene.n_real)
        want, n_want = np.asarray(want), int(n_want)
    finally:
        monkeypatch.undo()
        jpipeline._render_jit._clear_cache()

    soa = convert.soa_from_numpy(leaves(jscene.spheres, COLUMNS), "cpu")
    cam = convert.camera_from_numpy(leaves(jcam, convert.CAMERA_FIELDS),
                                    "cpu")
    cfg = RenderConfig(**kw)
    got, n_got = tpipeline.render_image_megakernel(
        soa, cam, cfg, n_real=jscene.n_real, respawn=False)
    assert abs(int(n_got) - n_want) <= RAY_TOL * n_want
    assert np.abs(got.numpy() - want).mean() <= IMG_TOL
    assert got.shape == (32, 64, 3) and torch.isfinite(got).all()

    resp, n_resp = tpipeline.render_image_megakernel(
        soa, cam, cfg, n_real=jscene.n_real)
    assert int(n_resp) == int(n_got)
    assert float((resp - got).abs().max()) <= SUM_ORDER_TOL
    wave, n_wave = tpipeline.render_image_megakernel(
        soa, cam, cfg, n_real=jscene.n_real, respawn=False,
        wavefront=(2, 3, 6))
    assert torch.equal(wave, got) and int(n_wave) == int(n_got)
    with pytest.raises(ValueError, match="alternative"):
        tpipeline.render_image_megakernel(soa, cam, cfg, respawn=True,
                                          wavefront=(2, 5))
