"""Multi-rank runs on gloo CPU ranks: the port's twin of
__graft_entry__.dryrun_multichip, and the rank runner its tests use.

    python -m rays1bench_tpu_torch.parallel.dryrun [N]

run_ranks(fn, n, workdir, *args) starts n >= 2 processes
(multiprocessing's spawn), which join one gloo group through
parallel.multihost.init with a file:// store under workdir (no port to
pick: several runs may share a machine); each calls fn(*args) and the
caller gets every rank's result. fn is a module-level function of an
importable module, so the workers the tests start run `rank_cases`, which
lives here and imports nothing of tests/ or JAX.

dryrun_multichip(n) runs on n ranks what the JAX dry run runs on n virtual
devices: the sharded plain render, the kernel engines' plain versions
(one-shot, respawn, and a 2-D mesh when n is even), one training step on
each gradient engine ("pipeline", and the fused "mega" path) and the
sharded fused loss against the single-device one. The JAX dry run's check
of its blocked fused backward (above 64 rows) has no counterpart: the
port's backward has one path for every table (kernels/mega_backward.py).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist

from rays1bench_tpu_torch.parallel import multihost


def _rank_main(fn, rank, n, workdir, args):
    torch.set_num_threads(1)
    multihost.init(f"file://{workdir}/store", n, rank, backend="gloo")
    try:
        torch.save(fn(*args), os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, workdir: str, *args, timeout: float = 900.0):
    """fn(*args) on each of n >= 2 gloo ranks; returns their results in
    rank order. Raises with a rank's traceback if any fails, and stops
    every rank left after `timeout` seconds."""
    if n < 2:
        raise ValueError(f"run_ranks starts 2 or more ranks, not {n}")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, workdir, args))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        for p in procs:
            left = (deadline - datetime.datetime.now()).total_seconds()
            p.join(max(left, 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = []
    for name in sorted(os.listdir(workdir)):
        if name.endswith(".err"):
            with open(os.path.join(workdir, name)) as f:
                errors.append(f.read())
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"ranks failed (exit codes "
                           f"{[p.exitcode for p in procs]}):\n"
                           + "\n".join(errors))
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"))
            for r in range(n)]


def _mesh(shape):
    from rays1bench_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
    if len(shape) == 1:
        return make_mesh(shape[0], device="cpu")
    return make_mesh2d(*shape, device="cpu")


def rank_cases(cases):
    """This rank's results of each case, in order (what the tests' ranks
    run). A case is (kind, scene, pad_multiple, RenderConfig fields, mesh
    shape, keyword arguments), on the CPU:

    - "plain": parallel.shard.render_image_sharded -> (image, rays);
    - "kernel": render_image_pallas_sharded(n_real=the scene's, **kw) ->
      (image, rays[, telemetry]); a 2-D shape shards "tiles" x "samples";
    - "grad": grad.inverse.image_loss against a 0.3 target, with
      kw["engine"] and kw["names"] (SphereSOA columns, kw["bump"] added to
      row 0 of the first), on the mesh or, with kw["local"], without one
      -> (loss, {column: gradient}, {camera field: gradient});
    - "fit": grad.inverse.fit_scene(mesh=..., engine=kw["engine"],
      kw["steps"] steps on the albedos against a 0.3 target) -> (losses,
      fitted albedo_x);
    - "cli": bench.cli.render_fn(parse_args(kw["argv"]), scene, mesh) ->
      (image, rays)."""
    import dataclasses

    from rays1bench_tpu_torch.core.config import RenderConfig
    from rays1bench_tpu_torch.grad import inverse
    from rays1bench_tpu_torch.parallel import shard
    from rays1bench_tpu_torch.scene import builders

    out = []
    for kind, scene_name, pad, cfg_kw, shape, kw in cases:
        cfg = RenderConfig(**cfg_kw)
        scene = builders.SCENES[scene_name](cfg.aspect, device="cpu",
                                            **({"pad_multiple": pad}
                                               if pad else {}))
        camera = scene.camera.build("cpu")
        mesh = _mesh(shape)
        if kind == "plain":
            out.append(shard.render_image_sharded(scene.spheres, camera, cfg,
                                                  mesh))
        elif kind == "kernel":
            if len(shape) == 2:
                kw = dict(kw, axis_name="tiles", sample_axis="samples")
            out.append(shard.render_image_pallas_sharded(
                scene.spheres, camera, cfg, mesh, n_real=scene.n_real, **kw))
        elif kind == "grad":
            params = inverse.params_of(scene.spheres, kw["names"])
            with torch.no_grad():
                params[kw["names"][0]][0] += kw.get("bump", 0.0)
            cam = dataclasses.replace(camera, **{
                f.name: getattr(camera, f.name).clone().requires_grad_(True)
                for f in dataclasses.fields(camera)})
            target = torch.full((cfg.height, cfg.width, 3), 0.3)
            loss = inverse.image_loss(params, scene.spheres, cam, target,
                                      cfg, None if kw.get("local") else mesh,
                                      kw["engine"])
            loss.backward()
            out.append((loss.detach(),
                        {k: v.grad for k, v in params.items()},
                        {f.name: getattr(cam, f.name).grad
                         for f in dataclasses.fields(cam)}))
        elif kind == "fit":
            inv = inverse.InverseConfig(steps=kw["steps"],
                                        learning_rate=1e-2,
                                        optimize=("albedo_x", "albedo_y",
                                                  "albedo_z"))
            target = torch.full((cfg.height, cfg.width, 3), 0.3)
            fitted, losses = inverse.fit_scene(
                scene.spheres, camera, target, cfg, inv, mesh=mesh,
                engine=kw["engine"], device="cpu")
            out.append((losses, fitted.albedo_x))
        elif kind == "cli":
            from rays1bench_tpu_torch.bench import cli
            fn = cli.render_fn(cli.parse_args(kw["argv"]), scene, mesh)
            out.append(fn(scene.spheres, camera, cfg))
        else:
            raise ValueError(f"unknown case kind {kind!r}")
    return out


def _check(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def _dryrun_rank(n: int):
    from rays1bench_tpu_torch.core.config import RenderConfig
    from rays1bench_tpu_torch.grad.inverse import (InverseConfig, image_loss,
                                                   make_train_step,
                                                   params_of)
    from rays1bench_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
    from rays1bench_tpu_torch.parallel.shard import (
        render_image_pallas_sharded, render_image_sharded)
    from rays1bench_tpu_torch.scene.builders import create_small_scene

    mesh = make_mesh(n, device="cpu")
    cfg = RenderConfig(width=64, height=32, spp=2, max_bounces=3,
                       ray_chunk=1024, early_exit=False)
    scene = create_small_scene(cfg.aspect, device="cpu")
    camera = scene.camera.build("cpu")

    image, num_rays = render_image_sharded(scene.spheres, camera, cfg, mesh)
    _check(image.shape == (cfg.height, cfg.width, 3) and int(num_rays) > 0,
           (image.shape, int(num_rays)))
    # The kernel engines' plain versions, sharded: identical per-ray
    # trajectories give identical counts.
    for kw in (dict(), dict(respawn=True)):
        img, num = render_image_pallas_sharded(
            scene.spheres, camera, cfg, mesh, n_real=scene.n_real, **kw)
        _check(img.shape == image.shape and int(num) == int(num_rays),
               (kw, img.shape, int(num), int(num_rays)))
    if n % 2 == 0:
        mesh2d = make_mesh2d(n // 2, 2, device="cpu")
        img, num = render_image_pallas_sharded(
            scene.spheres, camera, cfg, mesh2d, axis_name="tiles",
            sample_axis="samples", n_real=scene.n_real)
        _check(int(num) == int(num_rays), ("2-D mesh", int(num)))

    # One training step on each engine.
    inv = InverseConfig(steps=1)
    target = torch.zeros((cfg.height, cfg.width, 3))
    params = params_of(scene.spheres, inv.optimize)
    step, _ = make_train_step(scene.spheres, camera, cfg, inv, params, mesh,
                              engine="pipeline")
    loss = float(step(target))
    _check(loss >= 0.0, loss)
    scene8 = create_small_scene(cfg.aspect, pad_multiple=8, device="cpu")
    params_m = params_of(scene8.spheres, inv.optimize)
    start = {k: v.detach().clone() for k, v in params_m.items()}
    step_m, _ = make_train_step(scene8.spheres, camera, cfg, inv, params_m,
                                mesh, engine="mega")
    loss_m = float(step_m(target))
    # The sharded fused forward against the single-device one: identical
    # per-ray math and the same spp mean, so the loss is equal.
    with torch.no_grad():
        loss_1 = float(image_loss(start, scene8.spheres, camera, target, cfg,
                                  None, "mega"))
    _check(loss_m == loss_1, (loss_m, loss_1))
    return dict(loss=loss, loss_mega=loss_m, rays=int(num_rays))


def dryrun_multichip(n_devices: int = 4) -> dict:
    """Run the dry run on n_devices gloo CPU ranks (module docstring);
    raises on any failure, returns rank 0's summary."""
    with tempfile.TemporaryDirectory(prefix="rays1bench_dryrun_") as d:
        results = run_ranks(_dryrun_rank, n_devices, d, n_devices)
    if any(r != results[0] for r in results):
        raise AssertionError(f"ranks disagree: {results}")
    r = results[0]
    print(f"dryrun_multichip({n_devices}): ok, loss={r['loss']:.4f} "
          f"(engine=pipeline), mega_loss={r['loss_mega']:.4f} (engine=mega, "
          f"sharded, single-device cross-check passed), rays={r['rays']}",
          flush=True)
    return r


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
