"""Parity of the port's kernel path (rays1bench_tpu_torch.kernels) with the
JAX package's Pallas path on the CPU.

Bit-exact: the Morton permutation, the trimmed prepared scene, the packed
sphere and camera tables, the payload unpack, the sweep's winners. The
whole slice, render_image_megakernel (the respawn kernel's plain version on
the CPU) against render_image_pallas(respawn=True) in Pallas interpret mode,
carries the drift of XLA's jitted FMA contraction and rsqrt: measured small
64x32 @ 4 spp 14,691 rays on both sides (image mean abs gap 1.5e-8), medium
64x32 @ 2 spp 9,584 vs 9,585 (relative 1.0e-4, mean abs gap 4.7e-5).
Pinned: ray count relative gap <= 2e-3, image mean abs gap <= 1e-3.

The CUDA kernel itself runs only on a GPU: see tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rays1bench_tpu.bench import harness as jharness
from rays1bench_tpu.core.config import RenderConfig as JConfig
from rays1bench_tpu.kernels import culling as jculling
from rays1bench_tpu.kernels import megakernel as jmega
from rays1bench_tpu.kernels import pipeline as jpipeline
from rays1bench_tpu.render import intersect as jintersect
from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu_torch.bench import harness as tharness
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import build, culling, megakernel
from rays1bench_tpu_torch.kernels import pipeline as tpipeline
from rays1bench_tpu_torch.scene import builders as tbuilders
from rays1bench_tpu_torch.scene import convert
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS

torch.set_num_threads(1)

ASPECT = 1280 / 720
SCENES = ["small", "medium", "large", "giant"]


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def random_rays(seed, n=20_000, spread=6.0):
    r = np.random.default_rng(seed)
    o = (r.random((3, n)) * 2 - 1) * spread
    o[1] = np.abs(o[1]) + 0.2
    d = r.standard_normal((3, n))
    d /= np.linalg.norm(d, axis=0)
    return [x.astype(np.float32) for x in (*o, *d)]


@pytest.mark.parametrize("name", SCENES)
def test_morton_order_same_permutation(name):
    s = jbuilders.SCENES[name](ASPECT).spheres
    valid = s.radius != 0.0
    want = np.asarray(jculling.morton_order(s.center_x, s.center_y,
                                            s.center_z, valid))
    t = tbuilders.SCENES[name](ASPECT, device="cpu").spheres
    got = culling.morton_order(t.center_x, t.center_y, t.center_z,
                               t.radius != 0.0)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_morton_order_ties_keep_row_order():
    """Duplicate centers (equal codes) and placeholders: the stable sort
    must break ties by row exactly as the JAX sort does."""
    r = np.random.default_rng(0)
    c = r.integers(0, 4, (3, 300)).astype(np.float32)
    valid = r.random(300) < 0.8
    want = np.asarray(jculling.morton_order(*map(jnp.asarray, c),
                                            jnp.asarray(valid)))
    got = culling.morton_order(*map(torch.from_numpy, c),
                               torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("name,n_real", [("small", 5), ("medium", 46),
                                         ("large", 484), ("giant", 4096),
                                         ("small", None)])
def test_prepare_trimmed_bit_exact(name, n_real):
    want, _ = jpipeline.prepare_trimmed(jbuilders.SCENES[name](ASPECT).spheres,
                                        0, "sort_trim", n_real)
    got = tpipeline.prepare_trimmed(
        tbuilders.SCENES[name](ASPECT, device="cpu").spheres,
                                    n_real)
    for f in dataclasses.fields(want):
        assert same_bits(getattr(got, f.name).numpy(),
                         getattr(want, f.name)), f.name


@pytest.mark.parametrize("name", SCENES)
def test_pack_tables_bit_exact(name):
    jscene = jbuilders.SCENES[name](ASPECT)
    tscene = tbuilders.SCENES[name](ASPECT, device="cpu")
    jprep, _ = jpipeline.prepare_trimmed(jscene.spheres, 0, "sort_trim",
                                         jscene.n_real)
    tprep = tpipeline.prepare_trimmed(tscene.spheres, tscene.n_real)
    assert same_bits(megakernel.pack_spheres(tprep).numpy(),
                     jmega._pack_spheres(jprep))
    assert same_bits(
        megakernel.pack_camera(tscene.camera.build("cpu")).numpy(),
        np.asarray(jmega._pack_camera(jscene.camera.build()))[0])


def packed_large():
    scene = tbuilders.create_large_scene(ASPECT, device="cpu")
    return megakernel.pack_spheres(tpipeline.prepare_trimmed(scene.spheres,
                                                             scene.n_real))


def test_closest_hit_record_bit_exact():
    """The payload unpack (8-bit albedo times float32(1/255), mt*32+param)
    decodes to the JAX kernel's floats, on hit and miss lanes."""
    packed = packed_large()
    rays = random_rays(1)
    r = np.random.default_rng(2)
    best = r.integers(0, packed.shape[1], rays[0].shape[0])
    bt = r.random(best.shape[0]).astype(np.float32) * 20
    bt[::7] = np.inf
    p = packed.numpy()
    jbest = (jnp.asarray(bt),) + tuple(jnp.asarray(p[k][best])
                                       for k in (0, 1, 2, 4, 5, 6))
    *_, want = jmega._closest_hit_record(
        jbest, *map(jnp.asarray, rays))
    got = megakernel.closest_hit_record(packed, torch.from_numpy(best),
                                        torch.from_numpy(bt),
                                        *map(torch.from_numpy, rays))
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if w is None:
            continue
        assert same_bits(getattr(got, f.name).numpy(), w), f.name
    assert set(np.unique(got.mat_type.numpy())) == {0, 1, 2}


@pytest.mark.parametrize("name", ["small", "large"])
def test_sweep_winner_matches_jax_closest_hit(name):
    """The kernel's NaN-propagating first-wins sweep over the packed table
    picks the XLA sweep's winner and root (run on the same trimmed rows, each
    row's fuzz replaced by its index so the JAX record names the winner)."""
    jscene = jbuilders.SCENES[name](ASPECT)
    jprep, _ = jpipeline.prepare_trimmed(jscene.spheres, 0, "sort_trim",
                                         jscene.n_real)
    jprep = dataclasses.replace(
        jprep, fuzz=jnp.arange(jprep.count, dtype=jnp.float32))
    tscene = tbuilders.SCENES[name](ASPECT, device="cpu")
    packed = megakernel.pack_spheres(
        tpipeline.prepare_trimmed(tscene.spheres, tscene.n_real))
    rays = random_rays(3)
    want = jintersect.closest_hit(*map(jnp.asarray, rays), jprep, 1e-3, 3.4e38)
    best, bt = megakernel.sweep(packed, *map(torch.from_numpy, rays), 1e-3)
    hit = np.asarray(want.hit)
    assert 0.05 < hit.mean() < 0.95
    assert np.array_equal((bt < 3e38).numpy(), hit)
    assert np.array_equal(best.numpy()[hit],
                          np.asarray(want.fuzz)[hit].astype(np.int64))
    assert same_bits(bt.numpy()[hit], np.asarray(want.t)[hit])


def small_inputs(w=24, h=16, spp=3, mb=5):
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb, seed=3)
    scene = tbuilders.create_small_scene(cfg.aspect, device="cpu")
    packed = megakernel.pack_spheres(
        tpipeline.prepare_trimmed(scene.spheres, scene.n_real))
    return cfg, packed, megakernel.pack_camera(scene.camera.build("cpu"))


def test_respawn_reference_padding_lanes_never_count():
    cfg, packed, cam = small_inputs()
    n = cfg.num_pixels
    pid = torch.arange(n + 100, dtype=torch.int32).clamp_max(n)  # pad = n
    x = (pid % cfg.width).to(torch.float32)
    y = (pid // cfg.width).to(torch.float32)
    (rr, rg, rb), cnt = megakernel.trace_respawn_reference(packed, cam, pid,
                                                           x, y, cfg)
    assert (cnt[n:] == 0).all()
    assert all((c[n:] == 0).all() for c in (rr, rg, rb))
    (ur, ug, ub), ucnt = megakernel.trace_respawn_reference(
        packed, cam, pid[:n], x[:n], y[:n], cfg)
    assert torch.equal(cnt[:n], ucnt) and torch.equal(rr[:n], ur)
    assert (ucnt >= cfg.spp).all()


def test_trace_respawn_on_cpu_runs_the_plain_version():
    cfg, packed, cam = small_inputs()
    before = megakernel.LAUNCHES
    (rr, rg, rb), cnt, total = megakernel.trace_respawn(packed, cam, cfg)
    assert megakernel.LAUNCHES == before
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32)
    (ref_r, _, _), ref_cnt = megakernel.trace_respawn_reference(
        packed, cam, pid, (pid % cfg.width).float(),
        (pid // cfg.width).float(), cfg)
    assert torch.equal(rr, ref_r) and torch.equal(cnt, ref_cnt)
    assert total.dtype == torch.int64 and int(total) == int(cnt.sum())


def test_trace_respawn_rejects_bad_inputs():
    cfg, packed, cam = small_inputs()
    bad = [
        (packed.double(), cam, None),
        (packed[:6], cam, None),
        (packed.t().contiguous().t(), cam, None),   # not contiguous
        (packed, cam[:18], None),
        (packed, cam, (2, 1)),
        (packed, cam, (0, cfg.spp + 1)),
        (packed.to("meta"), cam.to("meta"), None),
    ]
    for p, c, span in bad:
        with pytest.raises(ValueError):
            megakernel.trace_respawn(p, c, cfg, span)


def test_sample_span_split_adds_up():
    cfg, packed, cam = small_inputs(spp=5)
    (full, _, _), cnt, total = megakernel.trace_respawn(packed, cam, cfg)
    (a, _, _), ca, ta = megakernel.trace_respawn(packed, cam, cfg, (0, 2))
    (b, _, _), cb, tb = megakernel.trace_respawn(packed, cam, cfg, (2, 5))
    assert torch.equal(ca + cb, cnt) and int(ta) + int(tb) == int(total)
    # float addition order only: two partial sums vs five serial adds
    assert float((a + b - full).abs().max()) <= 1e-5


def jax_leaves(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


@pytest.mark.parametrize("name,spp", [("small", 4), ("medium", 2)])
def test_slice_matches_jax_interpret(name, spp, monkeypatch):
    """render_image_megakernel on the CPU vs render_image_pallas(respawn=True)
    in Pallas interpret mode, on the same scene and camera (carried across
    with scene/convert.py)."""
    kw = dict(width=64, height=32, spp=spp, max_bounces=6, seed=11)
    jcfg = JConfig(**kw)
    jscene = jbuilders.SCENES[name](jcfg.aspect)
    jcam = jscene.camera.build()
    monkeypatch.setattr(jpipeline, "trace_pallas_respawn", functools.partial(
        jmega.trace_pallas_respawn, interpret=True))
    jpipeline._render_jit._clear_cache()
    try:
        want, n_want = jpipeline.render_image_pallas(
            jscene.spheres, jcam, jcfg, tile_rays=1024, unroll=4,
            n_real=jscene.n_real, respawn=True)
        want, n_want = np.asarray(want), int(n_want)
    finally:
        monkeypatch.undo()
        jpipeline._render_jit._clear_cache()

    soa = convert.soa_from_numpy(jax_leaves(jscene.spheres, COLUMNS), "cpu")
    cam = convert.camera_from_numpy(jax_leaves(jcam, convert.CAMERA_FIELDS),
                                    "cpu")
    got, n_got = tpipeline.render_image_megakernel(
        soa, cam, RenderConfig(**kw), n_real=jscene.n_real)
    n_got = int(n_got)
    assert abs(n_got - n_want) <= 2e-3 * n_want, (n_got, n_want)
    gap = np.abs(got.numpy() - want)
    assert gap.mean() <= 1e-3, gap.mean()
    assert got.shape == (32, 64, 3) and torch.isfinite(got).all()


def test_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build("respawn", "respawn.cu")
    assert list(tmp_path.iterdir()) == []


def test_build_flags_keep_ieee_math():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags and "fast_math" not in flags
    assert build.library_path("respawn", "respawn.cu") == \
        build.library_path("respawn", "respawn.cu")
    assert build.library_path("respawn", "respawn.cu").parent == build.BUILD_DIR


def test_log_results_matches_jax_format(tmp_path):
    runs = [(1.25, 631_039_957), (1.5, 631_039_959)]
    want = jharness.log_results(
        "large", [jharness.BenchResult(*r) for r in runs], version="v",
        directory=str(tmp_path))
    got = tharness.log_results(
        "large", [tharness.BenchResult(*r) for r in runs], version="v",
        directory=str(tmp_path))
    assert got == want
    assert (tmp_path / "out_large.txt").read_text() == want


def test_benchmark_needs_a_cuda_scene():
    scene = tbuilders.create_small_scene(2.0, device="cpu")
    cfg = RenderConfig(width=8, height=4, spp=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tharness.benchmark(scene, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tharness.benchmark_sustained(scene, cfg)
