"""The port's sharded renders (rays1bench_tpu_torch/parallel/) on the CPU,
against the JAX package's (rays1bench_tpu/parallel/) and against the
port's own single-device renders.

The port's ranks are four gloo processes (parallel/dryrun.run_ranks, which
run parallel/dryrun.rank_cases: the workers import nothing of tests/ or
JAX); the JAX side runs on the conftest's virtual CPU devices, its Pallas
kernels in interpret mode. Sizes are tests/test_shard.py's telemetry case:
the small scene at 48x24 @ 2 spp @ 4 b, 4 ranks and a 2x2 (tiles, samples)
mesh (4 spp).

Tolerances:
- Against JAX, the port's pinned ones (tests/test_torch_megakernel.py):
  ray-count relative gap <= 2e-3, image mean abs gap <= 1e-3 (XLA's rsqrt
  and FMA contraction move a few paths).
- Inside the port, bit for bit: the sharded plain render is render_image's
  image and count; the one-shot, wavefront and tile-mesh respawn images are
  render_image_megakernel's; on the 2x2 mesh the one-shot image too, and
  the respawn image within 1e-7 (each pixel's sample spans added in
  another order, as tests/test_shard.py allows the JAX package).
- Telemetry: device_rays sum to the total and iters > 0 where rays > 0
  (tests/test_shard.py:193). The per-rank split differs from JAX's (the
  port drops the slot permutation), so only sums are compared with JAX's.
  The respawn kernel's trips over a tile mesh sum to the single-device
  count (each rank holds whole 8-row blocks, every n_tiles-th), and so do
  the one-shot kernel's here (each rank's 576 rays are whole warps of 32).
  The interleaved split is also held, in one process, over every
  coordinate of a 4x1 and a 2x2 mesh on a frame of 44 rows (a ragged last
  block, ranks of 2, 2, 1 and 1 blocks).
"""

import numpy as np
import pytest
import torch

from rays1bench_tpu.core.config import RenderConfig as JConfig
from rays1bench_tpu.parallel.mesh import make_mesh as jmake_mesh
from rays1bench_tpu.parallel.mesh import make_mesh2d as jmake_mesh2d
from rays1bench_tpu.parallel.shard import \
    render_image_pallas_sharded as jpallas_sharded
from rays1bench_tpu.parallel.shard import \
    render_image_sharded as jrender_sharded
from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.kernels import megakernel
from rays1bench_tpu_torch.kernels.pipeline import (pack_camera, pack_spheres,
                                                   prepare_trimmed,
                                                   render_image_megakernel)
from rays1bench_tpu_torch.parallel import multihost, shard
from rays1bench_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                  rank_cases, run_ranks)
from rays1bench_tpu_torch.render.pipeline import render_image
from rays1bench_tpu_torch.scene import builders

torch.set_num_threads(1)

KW = dict(width=48, height=24, spp=2, max_bounces=4)
KW4 = dict(KW, spp=4)
CFG, CFG4 = RenderConfig(**KW), RenderConfig(**KW4)
RAY_TOL = 2e-3
IMG_TOL = 1e-3
# (name, case): every case of the port's four ranks, run once per module.
CASES = [
    ("plain", ("plain", "small", None, KW, (4,), {})),
    ("oneshot", ("kernel", "small", None, KW, (4,), dict(telemetry=True))),
    ("respawn", ("kernel", "small", None, KW, (4,),
                 dict(respawn=True, telemetry=True))),
    ("wavefront", ("kernel", "small", None, KW, (4,),
                   dict(wavefront=(2, 6)))),
    ("wavefront_1_2_8", ("kernel", "small", None, KW, (4,),
                         dict(wavefront=(1, 2, 8)))),
    ("cull_none", ("kernel", "small", None, KW, (4,), dict(cull="none"))),
    ("oneshot_2x2", ("kernel", "small", None, KW4, (2, 2),
                     dict(telemetry=True))),
    ("respawn_2x2", ("kernel", "small", None, KW4, (2, 2),
                     dict(respawn=True, telemetry=True))),
]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Rank 0's results of every case; each case's results on every rank
    must be rank 0's (every rank holds the whole image)."""
    ranks = run_ranks(rank_cases, 4, str(tmp_path_factory.mktemp("ranks")),
                      [c for _, c in CASES])
    for r in ranks[1:]:
        for name, a, b in zip((n for n, _ in CASES), r, ranks[0]):
            assert all(torch.equal(x, y) for x, y in zip(a[:2], b[:2])), name
    return dict(zip((n for n, _ in CASES), ranks[0]))


@pytest.fixture(scope="module")
def scene():
    s = builders.create_small_scene(CFG.aspect, device="cpu")
    return s, s.camera.build("cpu")


@pytest.fixture(scope="module")
def jscene():
    s = jbuilders.create_small_scene(CFG.aspect)
    return s, s.camera.build()


def megakernel_ref(scene, cfg, **kw):
    s, cam = scene
    return render_image_megakernel(s.spheres, cam, cfg, s.n_real, **kw)


def jax_gap(img, n, jimg, jn):
    rel = abs(int(n) - int(jn)) / int(jn)
    mean = float(np.abs(img.numpy() - np.asarray(jimg)).mean())
    assert rel <= RAY_TOL and mean <= IMG_TOL, (rel, mean)


def test_plain_sharded_equals_render_image_and_jax(port, scene, jscene):
    img, n = port["plain"]
    s, cam = scene
    ref, n_ref = render_image(s.spheres, cam, CFG)
    assert torch.equal(img, ref) and int(n) == int(n_ref)
    jimg, jn = jrender_sharded(jscene[0].spheres, jscene[1], JConfig(**KW),
                               jmake_mesh(4))
    jax_gap(img, n, jimg, jn)


@pytest.mark.parametrize("case,kw", [
    ("oneshot", dict(respawn=False)),
    ("respawn", dict(respawn=True)),
    ("wavefront", dict(respawn=False, wavefront=(2, 6))),
    ("wavefront_1_2_8", dict(respawn=False, wavefront=(1, 2, 8))),
])
def test_kernel_engines_equal_the_single_device_port(port, scene, case, kw):
    img, n = port[case][:2]
    ref, n_ref = megakernel_ref(scene, CFG, **kw)
    assert torch.equal(img, ref) and int(n) == int(n_ref), case


def test_cull_none_traces_the_rows_as_given(port, scene):
    """cull="none" packs the prepared rows unsorted: the same rays, so the
    same count as the sorted table, and the same image up to the sweep's
    first-wins ties (none here)."""
    img, n = port["cull_none"]
    ref, n_ref = megakernel_ref(scene, CFG, respawn=False)
    assert int(n) == int(n_ref) and torch.equal(img, ref)


def test_2d_mesh_equals_the_single_device_port(port, scene):
    img, n = port["oneshot_2x2"][:2]
    ref, n_ref = megakernel_ref(scene, CFG4, respawn=False)
    assert torch.equal(img, ref) and int(n) == int(n_ref)
    img, n = port["respawn_2x2"][:2]
    ref, n_ref = megakernel_ref(scene, CFG4, respawn=True)
    assert int(n) == int(n_ref)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-7, rtol=0)


@pytest.mark.parametrize("respawn", [False, True])
def test_kernel_path_against_jax(port, jscene, respawn):
    """One-shot and respawn, 4 ranks and (one-shot) 2x2, against JAX's
    render_image_pallas_sharded in interpret mode, telemetry on."""
    js, jcam = jscene
    img, n, telem = port["respawn" if respawn else "oneshot"]
    jimg, jn, jtelem = jpallas_sharded(
        js.spheres, jcam, JConfig(**KW), jmake_mesh(4), tile_rays=512,
        unroll=4, n_real=js.n_real, respawn=respawn, interpret=True,
        telemetry=True)
    jax_gap(img, n, jimg, jn)
    assert telem["device_rays"].shape == (4,)
    assert abs(int(telem["device_rays"].sum())
               - int(np.asarray(jtelem["device_rays"]).sum())) \
        <= RAY_TOL * int(jn)
    if not respawn:
        img, n, telem = port["oneshot_2x2"]
        jimg, jn, _ = jpallas_sharded(
            js.spheres, jcam, JConfig(**KW4), jmake_mesh2d(2, 2),
            axis_name="tiles", sample_axis="samples", tile_rays=512,
            unroll=4, n_real=js.n_real, interpret=True, telemetry=True)
        jax_gap(img, n, jimg, jn)


@pytest.mark.parametrize("case", ["oneshot", "respawn", "oneshot_2x2",
                                  "respawn_2x2"])
def test_telemetry(port, case):
    """Per-rank rays sum to the total, and every rank that traced rays ran
    trips; mesh-shaped as in JAX."""
    _, n, telem = port[case]
    rays, iters = telem["device_rays"], telem["device_iters"]
    assert rays.shape == iters.shape == ((2, 2) if "2x2" in case else (4,))
    assert int(rays.sum()) == int(n)
    assert bool((iters[rays > 0] > 0).all()), (rays, iters)


def test_trips_over_a_tile_mesh_sum_to_the_single_device_count(port, scene):
    """The plain trip counts of the respawn and one-shot kernels (the kernels'
    debug_iters on the CPU) summed over four ranks equal the single-device
    frame's; the respawn kernel's from its per-pixel counts on 8x4-pixel
    warps, the one-shot kernel's (8 rows: a thread per ray) from its per-ray
    counts on warps of 32 rays."""
    s, cam = scene
    packed = pack_spheres(prepare_trimmed(s.spheres, s.n_real))
    _, cnt, _, iters = megakernel.trace_respawn(packed, pack_camera(cam),
                                                CFG, debug_iters=True)
    assert int(iters) == int(megakernel.respawn_iters_reference(
        cnt, CFG.width))
    assert int(port["respawn"][2]["device_iters"].sum()) == int(iters)
    one = [shard.kernel_local(s.spheres, cam, CFG, (1, 1), (0, 0),
                              n_real=s.n_real, telemetry=True)]
    assert int(port["oneshot"][2]["device_iters"].sum()) == int(one[0].iters)


def test_trip_references_on_known_counts():
    """respawn: 8x4-pixel warps, ragged at the right and top edges; one-shot
    below 16 rows: warps of 32 consecutive rays; from 16 rows up the fewest
    trips any refill order takes, each ray holding a lane max(count, 1)
    trips."""
    cnt = torch.zeros(5 * 10, dtype=torch.int32)
    cnt[0] = 3          # warp (0, 0)
    cnt[9] = 5          # x = 9: warp (1, 0)
    cnt[4 * 10 + 2] = 7  # y = 4: warp (0, 1)
    assert int(megakernel.respawn_iters_reference(cnt, 10)) == 15
    rays = torch.tensor([0] * 31 + [4] + [2] * 3, dtype=torch.int32)
    assert int(megakernel.oneshot_iters_reference(rays, 8)) == 4 + 2
    # 31 padding rays (1 trip each) + 4 + 6 = 41 lane-trips: 2 warp trips.
    assert int(megakernel.oneshot_iters_reference(rays, 16)) == 2


@pytest.fixture(scope="module")
def tables(scene):
    s, cam = scene
    return pack_spheres(prepare_trimmed(s.spheres, s.n_real)), pack_camera(cam)


@pytest.fixture(scope="module")
def respawn_frame(tables):
    return megakernel.trace_respawn(*tables, CFG, debug_iters=True)


# rows= of trace_respawn on CFG's 24 rows (3 blocks of 8): contiguous bands
# (one ending inside a block, one empty) and strided sets of blocks.
BLOCK_SETS = [(8, 20), (24, 24), (0, 24, 2), (8, 24, 2), (0, 20, 2),
              (16, 24, 3), (8, 24, 4)]
MALFORMED = [(4, 20), (8, 25), (16, 8), (0, 24, 0), (4, 24, 2),
             (8, 24, -1)]


@pytest.mark.parametrize("rows", BLOCK_SETS + [
    pytest.param(r, id=f"malformed{r}") for r in MALFORMED])
def test_band_of_rows_equals_those_rows_of_the_frame(tables, respawn_frame,
                                                     rows):
    """A set of whole 8-row blocks (every stride-th from y_lo, cut at
    y_hi) gives those rows of the frame bit for bit, in image order, and
    their count and trips; a malformed set raises."""
    if rows in MALFORMED:
        with pytest.raises(ValueError, match="band"):
            megakernel.trace_respawn(*tables, CFG, rows=rows)
        return
    (rr, rg, rb), cnt, _, _ = respawn_frame
    (br, bg, bb), bcnt, btotal, biters = megakernel.trace_respawn(
        *tables, CFG, rows=rows, debug_iters=True)
    ys = megakernel.block_rows(CFG, rows)
    y_lo, y_hi = rows[:2]
    stride = rows[2] if len(rows) == 3 else 1
    assert ys.tolist() == [y for y in range(y_lo, y_hi)
                           if (y - y_lo) // 8 % stride == 0]
    pix = (ys[:, None] * CFG.width + torch.arange(CFG.width)).reshape(-1)
    assert all(torch.equal(a, b[pix]) for a, b in zip((br, bg, bb),
                                                      (rr, rg, rb)))
    assert torch.equal(bcnt, cnt[pix])
    assert int(btotal) == int(cnt[pix].sum())
    assert int(biters) == int(megakernel.respawn_iters_reference(
        cnt.reshape(-1, CFG.width)[ys], CFG.width))


# A frame of 44 rows: 6 blocks, the last one 4 rows; 4 ranks hold 2, 2, 1
# and 1 of them.
SPLIT_CFG = RenderConfig(width=24, height=44, spp=4, max_bounces=4)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_interleaved_split_over_every_coordinate(scene, tables, shape):
    """kernel_local's respawn engine on every coordinate of the mesh, then
    assemble_pixels: the single-device frame bit for bit (on the 2-D mesh
    the frame's sample spans added in the same order), its count and its
    trips; every block-row traced by one tile, every tile within one block
    of the others, and no padding row traced or counted."""
    s, cam = scene
    cfg, (n_tiles, n_samp) = SPLIT_CFG, shape
    coords = [(i, j) for i in range(n_tiles) for j in range(n_samp)]
    parts = [shard.kernel_local(s.spheres, cam, cfg, shape, c,
                                n_real=s.n_real, respawn=True,
                                telemetry=True) for c in coords]
    img = shard.assemble_pixels(torch.stack([p.rad for p in parts]), cfg,
                                shape)
    spp_loc = cfg.spp // n_samp
    spans = [megakernel.trace_respawn(*tables, cfg,
                                      (j * spp_loc, (j + 1) * spp_loc),
                                      debug_iters=True)
             for j in range(n_samp)]
    acc = torch.stack(spans[0][0])
    for span in spans[1:]:
        acc = acc + torch.stack(span[0])
    want = (acc.t() * (1.0 / cfg.spp)).reshape(cfg.height, cfg.width, 3)
    assert torch.equal(img, want)
    if n_samp == 1:
        ref, _ = megakernel_ref(scene, cfg, respawn=True)
        assert torch.equal(img, ref)
    assert sum(int(p.rays) for p in parts) == sum(int(t[2]) for t in spans)
    assert sum(int(p.iters) for p in parts) == sum(int(t[3]) for t in spans)
    assert all(int(p.iters) == int(megakernel.respawn_iters_reference(
        p.cnt, cfg.width)) for p in parts)
    rows = [megakernel.block_rows(cfg, shard.band(cfg, n_tiles, i)[0])
            for i in range(n_tiles)]
    blocks = [sorted({y // 8 for y in r.tolist()}) for r in rows]
    assert sorted(b for bs in blocks for b in bs) == list(range(6))
    assert max(map(len, blocks)) - min(map(len, blocks)) <= 1
    assert torch.equal(torch.cat(rows).sort().values,
                       torch.arange(cfg.height))
    per = shard.band(cfg, n_tiles, 0)[1]
    for (i, j), p in zip(coords, parts):
        real = len(rows[i]) * cfg.width
        assert p.cnt.numel() == real and int(p.cnt.sum()) == int(p.rays)
        assert p.rad.shape == (3, per * cfg.width)
        assert not p.rad[:, real:].any()


def test_wavefront_refuses_telemetry(scene):
    s, cam = scene
    with pytest.raises(ValueError, match="wavefront"):
        shard.kernel_local(s.spheres, cam, CFG, (1, 1), (0, 0),
                           wavefront=(2, 6), telemetry=True)


def test_render_with_retry_recovers():
    calls = {"n": 0}

    def flaky(ids):
        calls["n"] += 1
        if calls["n"] == 2:  # second shard fails once
            raise RuntimeError("simulated device failure")
        return ids.to(torch.float32) * 2.0

    out, retried = multihost.render_with_retry(
        flaky, [torch.arange(4), torch.arange(4, 8)])
    assert torch.equal(out, torch.arange(8, dtype=torch.float32) * 2.0)
    assert retried == 1


def test_render_image_with_retry_is_bit_exact(scene):
    """Injected transient shard failures: the image equals render_image's
    and the clean retried render's bit for bit, with the same count."""
    s, cam = scene
    cfg = RenderConfig(width=64, height=40, spp=2, max_bounces=6,
                       ray_chunk=2048)
    ref, n_ref = render_image(s.spheres, cam, cfg)
    clean, n_clean, r0 = multihost.render_image_with_retry(s.spheres, cam,
                                                           cfg)
    fails = {"left": 2}

    def inject(fn):
        def wrapped(ids):
            if fails["left"]:
                fails["left"] -= 1
                raise RuntimeError("transient")
            return fn(ids)
        return wrapped

    img, n, retried = multihost.render_image_with_retry(
        s.spheres, cam, cfg, _render_shard=inject)
    assert (r0, retried) == (0, 2)
    assert torch.equal(clean, ref) and torch.equal(img, ref)
    assert n == n_clean == int(n_ref)


def test_two_process_sharded_render_and_fused_gradient(tmp_path, scene):
    """Two gloo processes (tests/test_multiprocess.py's case): the sharded
    plain render equals the one-process render bit for bit, and one fused
    gradient across both ranks ("mega", the (10, S) all_reduce) has the
    one-process loss and gradients within 1e-4, the same on both ranks."""
    kw = dict(width=64, height=32, spp=2, max_bounces=4, ray_chunk=1024)
    gkw = dict(kw, max_bounces=2, early_exit=False)
    grad = dict(engine="mega", names=("albedo_x",))
    ranks = run_ranks(rank_cases, 2, str(tmp_path), [
        ("plain", "small", None, kw, (2,), {}),
        ("grad", "small", 8, gkw, (2,), grad),
        ("grad", "small", 8, gkw, (2,), dict(grad, local=True))])
    s, cam = scene
    ref, n_ref = render_image(s.spheres, cam, RenderConfig(**kw))
    for (img, n), (loss, g, _), (loss1, g1, _) in ranks:
        assert torch.equal(img, ref) and int(n) == int(n_ref)
        assert float(loss) == float(loss1)
        gap = (g["albedo_x"] - g1["albedo_x"]).abs().max()
        assert float(gap) <= 1e-4 * float(g1["albedo_x"].abs().max())
        assert torch.equal(g["albedo_x"], ranks[0][1][1]["albedo_x"])
        assert torch.isfinite(g["albedo_x"]).all()
        assert float(g["albedo_x"].abs().sum()) > 0


def test_dryrun_multichip_on_four_ranks():
    """The twin of __graft_entry__.dryrun_multichip: renders, a training step
    on each engine and the fused cross-check, on four gloo ranks."""
    r = dryrun_multichip(4)
    assert r["rays"] > 0 and r["loss"] >= 0 and r["loss_mega"] >= 0
