"""The port's multi-scene CLI (rays1bench_tpu_torch.bench.cli) on the CPU:
its flags and defaults (those of rays1bench_tpu/bench/cli.py), the config
it builds (get_config, as the JAX package's), the engines it picks, and the
out_<scene>.txt records it writes, which the JAX package's report parser
reads. The timed frames need a card: here the harness is replaced by a
stand-in that returns fixed results, and without one main() raises."""

import dataclasses

import pytest
import torch

from rays1bench_tpu.bench import report as jreport
from rays1bench_tpu.core import config as jconfig
from rays1bench_tpu_torch.bench import cli, harness
from rays1bench_tpu_torch.bench import profile as bench_profile
from rays1bench_tpu_torch.core import config as tconfig
from rays1bench_tpu_torch.kernels.pipeline import render_image_megakernel
from rays1bench_tpu_torch.parallel.dryrun import rank_cases, run_ranks
from rays1bench_tpu_torch.render.pipeline import render_image
from rays1bench_tpu_torch.scene import builders, tga

torch.set_num_threads(1)


def test_flags_and_defaults():
    a = cli.parse_args([])
    assert a.scene_names == ["small", "medium", "large"]
    assert (a.quick, a.save, a.num, a.spp, a.max_bounces) == \
        (False, False, 1, None, None)
    assert (a.engine, a.respawn, a.sustained, a.out_dir, a.label) == \
        ("kernel", False, 0, ".", None)
    a = cli.parse_args(["--scenes", "giant, small", "--quick", "-w", "-n",
                        "3", "--spp", "2", "--max-bounces", "4", "--engine",
                        "plain", "--respawn", "--sustained", "5",
                        "--out-dir", "d", "--label", "v"])
    assert a.scene_names == ["giant", "small"] and a.save and a.num == 3
    assert (a.spp, a.max_bounces, a.engine, a.respawn, a.sustained) == \
        (2, 4, "plain", True, 5)
    for bad in (["--num", "0"], ["--num", "32"], ["--scenes", "tiny"],
                ["--engine", "pallas"]):
        with pytest.raises(SystemExit):
            cli.parse_args(bad)


@pytest.mark.parametrize("flags", [["--sharded", "2"],
                                   ["--profile", "trace_dir"], ["--report"]])
def test_unported_flags_name_their_roadmap_item(flags, tmp_path):
    """--profile and --report raise. --sharded is ported: under two gloo
    ranks (parallel/dryrun.run_ranks) --sharded 2 renders, through each
    engine's sharded path, every rank the image and count of the engine
    without a mesh."""
    if flags[0] != "--sharded":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.main(flags)
        return
    assert cli.parse_args(flags).sharded == 2
    kw = dict(width=16, height=8, spp=2, max_bounces=4)
    argvs = (flags, flags + ["--respawn"], flags + ["--engine", "plain"])
    ranks = run_ranks(rank_cases, 2, str(tmp_path),
                      [("cli", "small", None, kw, (2,), dict(argv=a))
                       for a in argvs])
    cfg = tconfig.RenderConfig(**kw)
    scene = builders.create_small_scene(cfg.aspect, device="cpu")
    camera = scene.camera.build("cpu")
    for argv, *got in zip(argvs, *ranks):
        want, n_want = cli.render_fn(cli.parse_args(argv[2:]), scene)(
            scene.spheres, camera, cfg)
        for img, n in got:
            assert torch.equal(img, want) and int(n) == int(n_want), argv


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(["--scenes", "small", "--quick"])


@pytest.mark.parametrize("argv,name,over", [
    ([], "full", {}),
    (["--quick"], "quick", {}),
    (["--quick", "--spp", "2", "--max-bounces", "0"], "quick",
     dict(spp=2, max_bounces=0)),
])
def test_config_is_get_config(argv, name, over):
    got = cli.config(cli.parse_args(argv))
    assert got == tconfig.get_config(name, **over)
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(jconfig.get_config(name, **over))


@pytest.mark.parametrize("argv,respawn", [([], False), (["--respawn"], True)])
def test_kernel_engine_is_the_one_shot_unless_respawn(argv, respawn):
    cfg = tconfig.RenderConfig(width=16, height=8, spp=2, max_bounces=4)
    scene = builders.create_small_scene(cfg.aspect, device="cpu")
    camera = scene.camera.build("cpu")
    fn = cli.render_fn(cli.parse_args(argv), scene)
    img, n = fn(scene.spheres, camera, cfg)
    want, n_want = render_image_megakernel(scene.spheres, camera, cfg,
                                           scene.n_real, respawn=respawn)
    assert torch.equal(img, want) and int(n) == int(n_want)
    assert cli.render_fn(cli.parse_args(["--engine", "plain"]),
                         scene) is render_image


def test_records_parse_with_the_jax_report(tmp_path, monkeypatch, capsys):
    """main() through a stand-in harness: one out_<scene>.txt per scene in
    the reference's pipe format, an out_<scene>.tga with -w (rendered by
    the one-shot engine's plain version here), and the per-scene block on
    stdout."""
    small, medium = builders.SCENES["small"], builders.SCENES["medium"]
    monkeypatch.setitem(builders.SCENES, "small",
                        lambda aspect, device: small(aspect, device="cpu"))
    monkeypatch.setitem(builders.SCENES, "medium",
                        lambda aspect, device: medium(aspect, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_profile, "smi", lambda *q: ["Card, 700.00 W"])
    runs = [harness.BenchResult(0.5, 1_000_000),
            harness.BenchResult(0.25, 1_000_002)]
    seen = []

    def fake_benchmark(scene, cfg, num_runs=1, render_fn=None):
        seen.append((scene.name, cfg, num_runs))
        return runs[:num_runs]

    monkeypatch.setattr(harness, "benchmark", fake_benchmark)
    cli.main(["--scenes", "small,medium", "--quick", "-n", "2", "-w",
              "--max-bounces", "3", "--out-dir", str(tmp_path), "--label",
              "port"])
    out = capsys.readouterr().out
    assert out.startswith("card: Card, 700.00 W\n")
    assert "medium\nelapsed time:\t0.250s\ntotal rays:\t1000002\n" \
        "mrays/s:\t4.00\n" in out
    assert [s[0] for s in seen] == ["small", "medium"]
    assert seen[0][1] == tconfig.get_config("quick", max_bounces=3)
    assert seen[0][2] == 2
    for name in ("small", "medium"):
        assert tga.read_rgb24(str(tmp_path / f"out_{name}.tga")).shape == \
            (60, 80, 3)
        text = (tmp_path / f"out_{name}.txt").read_text()
        assert text == "port|0.375s|1000001|2.667 mrays/s|"
        rec, = jreport.collect([str(tmp_path)], name)
        assert (rec.version, rec.rays) == ("port", 1_000_001)
