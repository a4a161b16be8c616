"""Parity of the port's tooling and small modules with the JAX package's on
the CPU: grad/fd.fd_check, the SphereSOA builder's mutations and astype,
bench/report and report_cli on the checked-in records/, utils/metrics,
utils/profiling on torch.profiler, the native runtime (runtime/native.py,
its own copy of imageio.cpp built into build/) and bench/scaling on gloo
ranks. Inputs are seeded with numpy and go through both packages.

Tolerances and why:
- fd_check, on the scene of tests/test_grad.py:45-67 (a metal sphere that
  fills the frame, 48x32 @ 2 spp @ 2 b, engine "pipeline", the JAX CPU
  default): each analytic entry within FD_ANALYTIC_TOL relative of the JAX
  package's (its gradient goes through XLA's rsqrt and FMAs); each numeric
  one resolvable above the float32 noise floor within the JAX test's 0.02
  of the port's own analytic entry.
- Builder mutations, astype, report strings, metrics: equal.
- Native runtime: equal bytes and bits, against its numpy twins and against
  the JAX package's library on the same arrays.
- Scaling on two gloo ranks: each point's ray count equal to one rank's
  (the RNG keys on global ray ids), and within the pinned 2e-3 (RAY_TOL,
  ROADMAP.md) of the JAX sweep's on the same config.
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from rays1bench_tpu.bench import report as jreport
from rays1bench_tpu.bench import report_cli as jreport_cli
from rays1bench_tpu.core.config import RenderConfig as JConfig
from rays1bench_tpu.grad import inverse as jinverse
from rays1bench_tpu.grad.fd import fd_check as jfd_check
from rays1bench_tpu.render.camera import CameraSpec as JCameraSpec
from rays1bench_tpu.runtime import native as jnative
from rays1bench_tpu.scene import soa_spheres as jsoa
from rays1bench_tpu.scene.spheres import METAL as JMETAL
from rays1bench_tpu.utils import metrics as jmetrics
from rays1bench_tpu_torch.bench import report, report_cli, scaling
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad import inverse
from rays1bench_tpu_torch.grad.fd import fd_check
from rays1bench_tpu_torch.render.camera import CameraSpec
from rays1bench_tpu_torch.runtime import build as rt_build
from rays1bench_tpu_torch.runtime import native
from rays1bench_tpu_torch.scene import tga
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS, SphereSOABuilder
from rays1bench_tpu_torch.scene.spheres import METAL
from rays1bench_tpu_torch.utils import metrics, profiling

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
FD_ANALYTIC_TOL = 2e-3
FD_REL_TOL = 0.02          # tests/test_grad.py:71
FD_NOISE_FLOOR = 5e-6      # tests/test_grad.py:66
RAY_TOL = 2e-3
FD_NAMES = ("center_x", "center_y", "center_z", "radius", "albedo_x",
            "albedo_y", "albedo_z")


def _fd_rows(jax_side):
    """fd_check's rows on tests/test_grad.py's metal scene, through one
    package."""
    kw = dict(width=48, height=32, spp=2, max_bounces=2, ray_chunk=8192,
              early_exit=False, seed=5)
    cam = dict(lookfrom=(0, 0, 2.4), lookat=(0, 0, 0), vfov=45,
               aperture=0.0, focus_dist=3.0)

    def scene(builder, metal, c=(0., 0., 0.), r=2.0, a=(0.9, 0.8, 0.7)):
        b = builder()
        b.add(c[0], c[1], c[2], r, metal, a[0], a[1], a[2], 0.0, 1.0)
        return b

    moved = dict(c=(0.05, -0.03, 0.1), r=1.95, a=(0.8, 0.85, 0.75))
    coords = [(n, 0) for n in FD_NAMES]
    if jax_side:
        cfg = JConfig(**kw)
        spheres = scene(jsoa.SphereSOABuilder, JMETAL).finalize(8)
        camera = JCameraSpec(aspect=cfg.aspect, **cam).build()
        target = jinverse.render_for_loss(
            scene(jsoa.SphereSOABuilder, JMETAL, **moved).finalize(8),
            camera, cfg, engine="pipeline")
        params = jinverse.params_of(spheres, FD_NAMES)
        f = lambda p: jinverse.image_loss(p, spheres, camera, target, cfg,
                                          engine="pipeline")
        return jfd_check(f, params, coords, eps=1e-3)
    cfg = RenderConfig(**kw)
    spheres = scene(SphereSOABuilder, METAL).finalize(8, device="cpu")
    camera = CameraSpec(aspect=cfg.aspect, **cam).build("cpu")
    with torch.no_grad():
        target = inverse.render_for_loss(
            scene(SphereSOABuilder, METAL, **moved).finalize(8, device="cpu"),
            camera, cfg, engine="pipeline")
    params = {n: getattr(spheres, n) for n in FD_NAMES}
    f = lambda p: inverse.image_loss(p, spheres, camera, target, cfg,
                                     engine="pipeline")
    return fd_check(f, params, coords, eps=1e-3)


def test_fd_check_rows_match_jax():
    got, want = _fd_rows(False), _fd_rows(True)
    assert [r[:2] for r in got] == [r[:2] for r in want] == \
        [(n, 0) for n in FD_NAMES]
    for (name, _, analytic, numeric, abs_err, rel_err), w in zip(got, want):
        assert abs(analytic - w[2]) <= FD_ANALYTIC_TOL * max(abs(w[2]),
                                                             1e-12), name
        assert abs_err == abs(analytic - numeric)
        if abs(numeric) < FD_NOISE_FLOOR:
            assert abs(analytic) < 1e-4, name
        else:
            assert rel_err < FD_REL_TOL, (name, analytic, numeric)


def _mutate(builder):
    """The same rows and mutations through either package's builder."""
    rng = np.random.default_rng(4)
    rows = rng.uniform(-3, 3, (9, 10))
    b = builder()
    b.reserve(32)
    for row in rows:
        b.add(*[float(v) for v in row[:4]], int(row[4] > 0),
              *[float(v) for v in row[5:]])
    b.remove(2)
    b.remove(b.count - 1)
    b.remove(0)
    other = builder()
    other.copy_from(b)
    other.add(*[0.5] * 4, 2, *[0.25] * 5)
    b.remove(1)
    return b, other


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_builder_mutations_and_astype_match_jax(dtype):
    import jax.numpy as jnp

    (tb, tother), (jb, jother) = _mutate(SphereSOABuilder), \
        _mutate(jsoa.SphereSOABuilder)
    assert (tb.count, tother.count) == (jb.count, jother.count) == (5, 7)
    for t, j in ((tb, jb), (tother, jother)):
        got, want = t.finalize(8, device="cpu"), j.finalize(8)
        got_cast, want_cast = got.astype(getattr(torch, dtype)), \
            want.astype(getattr(jnp, dtype))
        for name in COLUMNS:
            g, w = getattr(got, name), np.asarray(getattr(want, name))
            assert g.numpy().tobytes() == w.tobytes(), name
            g, w = getattr(got_cast, name), getattr(want_cast, name)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
            bits = torch.int16 if g.element_size() == 2 else torch.int32
            g_bits = g.view(bits).numpy() if g.is_floating_point() else \
                g.numpy()
            assert g_bits.tobytes() == np.asarray(w).tobytes(), name


def test_report_and_report_cli_match_jax_on_the_records():
    """report.collect / markdown_table and every report_cli table on the
    checked-in records/ give the JAX package's strings (the headline's
    records column named as the JAX CLI names it)."""
    rec = str(REPO / "records")
    dirs = [os.path.join(rec, "ref_matched"), rec]
    full = [os.path.join(rec, d) for d in ("full_ref_box", "full_oneshot",
                                           "full")]
    for scene in ("large", "medium", "small"):
        got, want = report.collect(dirs, scene), jreport.collect(dirs, scene)
        assert [vars(r) for r in got] == [vars(r) for r in want]
        assert report.markdown_table(got) == jreport.markdown_table(want)
        for fn in ("scene_table", "full_table"):
            assert getattr(report_cli, fn)(dirs, scene) == \
                getattr(jreport_cli, fn)(dirs, scene), (fn, scene)
    scenes = ["large", "medium", "small"]
    assert report_cli.generate(dirs, scenes) == \
        jreport_cli.generate(dirs, scenes)
    label = "This framework (1× v5e)"
    assert report_cli.headline_table(full[-1:], scenes, label) == \
        jreport_cli.headline_table(full[-1:], scenes)
    for fn, path in (("grad_table", "grad/steps.txt"),
                     ("scaling_table", "scaling/sweep.txt")):
        assert getattr(report_cli, fn)(os.path.join(rec, path)) == \
            getattr(jreport_cli, fn)(os.path.join(rec, path)), fn
    assert report_cli.build_subs(dirs, scenes, full_dirs=full,
                                 grad_path=os.path.join(rec, "grad",
                                                        "steps.txt"),
                                 scaling_path=os.path.join(
                                     rec, "scaling", "sweep.txt"),
                                 label=label) == \
        jreport_cli.build_subs(dirs, scenes, full_dirs=tuple(full),
                               grad_path=os.path.join(rec, "grad",
                                                      "steps.txt"),
                               scaling_path=os.path.join(rec, "scaling",
                                                         "sweep.txt"))


def test_report_cli_writes_only_where_it_is_pointed(tmp_path, monkeypatch,
                                                    capsys):
    """No default output file and no default record directory: a run from
    the repo root prints, and writes RESULTS.md / README.md nowhere."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "RESULTS_template.md").write_text("t: __RESULTS_SMALL__")
    (tmp_path / "README_template.md").write_text("r")
    with pytest.raises(SystemExit):
        report_cli.main([])
    report_cli.main(["--dirs", str(REPO / "records"), "--scenes", "small"])
    assert "## small" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["README_template.md",
                                            "RESULTS_template.md"]
    report_cli.main(["--dirs", str(REPO / "records"), "--scenes", "small",
                     "--template", "RESULTS_template.md", "--out", "o.md"])
    assert (tmp_path / "o.md").read_text().startswith("t: | version |")


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        rays, secs = int(rng.integers(1, 10**10)), float(rng.uniform(0, 9))
        assert metrics.mrays_per_sec(rays, secs) == \
            jmetrics.mrays_per_sec(rays, secs)
        assert metrics.samples_per_sec(1280, 720, 4, secs) == \
            jmetrics.samples_per_sec(1280, 720, 4, secs)
    assert metrics.mrays_per_sec(5, 0.0) == jmetrics.mrays_per_sec(5, 0.0)
    pts = [(1, 10**6, 0.5), (2, 10**6, 0.3), (4, 10**6 + 3, 0.2)]
    assert metrics.scaling_efficiency(
        [metrics.ScalingPoint(*p) for p in pts]) == \
        jmetrics.scaling_efficiency([jmetrics.ScalingPoint(*p) for p in pts])
    assert metrics.scaling_efficiency([]) == []


def test_profiling_on_the_cpu(tmp_path):
    """trace() writes one Chrome trace holding the annotated span;
    device_memory_stats is None on the CPU, as the JAX version's where the
    backend keeps no stats."""
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("rays1bench_span"):
            torch.ones(64).mul(2)
    files = profiling.trace_files(str(tmp_path / "t"))
    assert len(files) == 1 and files[0].endswith(profiling.TRACE_SUFFIX)
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "rays1bench_span" in names
    assert profiling.device_memory_stats("cpu") is None


def test_native_runtime_matches_its_twins_and_the_jax_library(tmp_path,
                                                              monkeypatch):
    """The JAX package's library is built from its own source with its own
    flags, into tmp_path (not beside its source, which
    tests/test_runtime.py builds, maybe at the same time in another
    worker)."""
    from rays1bench_tpu.runtime import build as jbuild

    monkeypatch.setattr(jbuild, "OUT", str(tmp_path / "libraysrt.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_tried", False)
    if not jnative.available():
        pytest.fail("the JAX package's native runtime did not build")
    if not native.available():
        pytest.fail(f"the native runtime did not build: {native.status()}")
    path = rt_build.library_path()
    assert path.exists() and path.parent == rt_build.BUILD_DIR
    assert REPO / "build" in path.parents
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.2, 1.4, size=(37, 53, 3)).astype(np.float32)
    got = native.tonemap_u8(x)
    assert np.array_equal(got, native.tonemap_u8_reference(x))
    assert np.array_equal(got, jnative.tonemap_u8(x))
    assert np.array_equal(got, (np.sqrt(np.clip(x, 0, 1)) * 255.99).astype(
        np.uint8))
    shards = [rng.normal(size=(1000,)).astype(np.float32) for _ in range(5)]
    got = native.accumulate_mean(shards)
    assert got.tobytes() == native.accumulate_mean_reference(shards).tobytes()
    assert got.tobytes() == jnative.accumulate_mean(shards).tobytes()
    with pytest.raises(ValueError):
        native.accumulate_mean([shards[0], shards[1][:10]])
    img = rng.integers(0, 256, size=(45, 67, 3), dtype=np.uint8)
    paths = [str(tmp_path / f"{k}.tga") for k in ("port", "plain", "jax")]
    native.tga_write_rgb24(paths[0], img)
    tga.write_rgb24(paths[1], img)
    jnative.tga_write_rgb24(paths[2], img)
    data = [pathlib.Path(p).read_bytes() for p in paths]
    assert data[0] == data[1] == data[2]
    assert np.array_equal(native.tga_read_rgb24(paths[0]), img)
    golden = str(REPO / "tests" / "golden" / "latest_quick_small.tga")
    assert np.array_equal(native.tga_read_rgb24(golden),
                          tga.read_rgb24(golden))
    with pytest.raises(ValueError):
        native.tga_write_rgb24(paths[0], img.astype(np.float32))


def test_scaling_on_two_gloo_ranks_matches_one_rank_and_jax(tmp_path,
                                                            capsys):
    from rays1bench_tpu.bench import scaling as jscaling

    kw = dict(width=32, height=16, spp=2, max_bounces=4)
    argv = ["--cpu", "--scene", "small", "--devices", "1,2", "--runs", "1",
            "--width", "32", "--height", "16", "--spp", "2",
            "--max-bounces", "4", "--telemetry", "--record",
            str(tmp_path / "sweep.txt")]
    points, telems = scaling.main(argv)
    assert [p.n_devices for p in points] == [1, 2]
    assert points[0].num_rays == points[1].num_rays > 0
    assert [sum(t["device_rays"]) for t in telems] == \
        [p.num_rays for p in points]
    assert len(telems[1]["device_iters"]) == 2
    effs = metrics.scaling_efficiency(points)
    assert effs[0] == 1.0
    jpoints = jscaling.sweep("small", JConfig(ray_chunk=16384, **kw), [1, 2],
                             runs=1, engine="xla")
    for p, j in zip(points, jpoints):
        assert abs(p.num_rays - j.num_rays) <= RAY_TOL * j.num_rays
    out = capsys.readouterr().out
    assert "gloo CPU ranks" in out and "per-rank trips" in out
    lines = (tmp_path / "sweep.txt").read_text().splitlines()
    assert [ln.split("|")[1] for ln in lines if not ln.startswith("#")] == \
        ["1", "2"]
    assert report_cli.scaling_table(str(tmp_path / "sweep.txt")).count(
        "| small 32x16") == 2


def test_inverse_rendering_example_on_the_cpu(capsys):
    """The example's albedo fit, one step through --cpu (its flags are those
    of examples/inverse_rendering.py, --cpu asking for the plain versions);
    --scene medium takes only the albedo fit; the default device is the
    card."""
    from rays1bench_tpu_torch.examples import inverse_rendering

    losses = inverse_rendering.main(["--cpu", "--steps", "1"])
    assert len(losses) == 1
    out = capsys.readouterr().out
    assert "albedo_x  abs error before: [0.08" in out
    args = inverse_rendering.parse_args([])
    assert (args.steps, args.lr, args.scene, args.engine, args.cpu) == \
        (120, 0.0, "small", "auto", False)
    for bad in (["--scene", "medium", "--fit-camera"],
                ["--fit-geometry", "--fit-camera"]):
        with pytest.raises(SystemExit):
            inverse_rendering.parse_args(bad)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--cpu"):
            inverse_rendering.main(["--steps", "1"])
