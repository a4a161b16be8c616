"""Window loop of the sharded render: one frame over `ranks` cards.

The process that runs the cell is rank 0; it starts ranks 1.. as processes
of their own (spawned, one card each) and they meet through a file store
under the run's TMPDIR, named for this process and moment. Every rank makes
the same inputs from the seed and calls parallel/shard.
render_image_pallas_sharded on a 1-D NCCL mesh with the mix's engine; the
image is all-gathered and the count all-reduced inside it. After two
warm-up frames rank 0 times `probe_frames` frames, sets the window's frame
count to fill --seconds at that pace and broadcasts it; every rank then
issues that many frames, at most `in_flight` queued. A traced run profiles
every rank's window, each in memory, and renders with telemetry (the
kernels' per-rank warp trips); its busy and window seconds are averaged
over the ranks, and the rest of its trace is rank 0's.

Every rank destroys its process group. Rank 0 joins the others with a time
limit; any rank's failure prints its traceback and makes the run fail. The
check is the render loop's, on rank 0's gathered last frame.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import sys
import tempfile
import time
import traceback

import torch

from port_bench.loops import common

JOIN_S = 120
GROUP_TIMEOUT_S = 180


def _rank(run: common.Run, rank: int, world: int, store: str) -> dict:
    import torch.distributed as dist
    from rays1bench_tpu_torch.core.config import RenderConfig
    from rays1bench_tpu_torch.parallel.mesh import make_mesh
    from rays1bench_tpu_torch.parallel.shard import render_image_pallas_sharded
    dev = run.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if cuda else "gloo", store=dist.FileStore(store, world),
        rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        traffic = run.cell["traffic"]
        mesh = make_mesh(world, device=dev.type)
        r = common.settings(run)
        cols, n_real, cam_spec, seed, rng = common.inputs(run)
        draws = common.check_draws(run, r, rng) if rank == 0 else None
        soa, camera = common.program_scene(cols, cam_spec, r, dev)
        cfg = RenderConfig(width=r["width"], height=r["height"],
                           spp=r["spp"], max_bounces=r["max_bounces"],
                           seed=seed)
        telemetry = []

        def frame():
            out = render_image_pallas_sharded(
                soa, camera, cfg, mesh, n_real=n_real,
                respawn=traffic["engine"] == "respawn",
                telemetry=run.trace)
            if run.trace:
                telemetry[:] = [out[2]["device_iters"]]
            return out[0], out[1]

        for _ in range(traffic["warmup_frames"]):
            frame()
        common.sync(dev)
        t = time.perf_counter()
        for _ in range(traffic["probe_frames"]):
            frame()
        common.sync(dev)
        per_frame = (time.perf_counter() - t) / traffic["probe_frames"]
        n = torch.tensor([max(1, round(run.seconds / per_frame))],
                         device=dev)
        dist.broadcast(n, src=0)
        n = int(n)
        dist.barrier()
        setup_s = time.perf_counter() - run.t_start
        with common.window(run) as win:
            image, counts = common.closed_loop(
                frame, traffic["in_flight"], dev, win, lambda k: k >= n)
        summary = win.summary()
        mine = {"peak": common.memory_peak(dev),
                "busy_s": summary and summary["busy_s"],
                "compute_s": summary and summary["compute_s"],
                "window_s": summary and summary["window_s"]}
        every = [None] * world
        dist.all_gather_object(every, mine)
        return dict(setup_s=setup_s, window_s=win.seconds,
                    counts=torch.stack(counts).cpu(),
                    image=image.float().cpu(), every=every, summary=summary,
                    iters=telemetry[0].cpu() if telemetry else None,
                    r=r, cols=cols, n_real=n_real, cam_spec=cam_spec,
                    seed=seed, draws=draws)
    finally:
        dist.destroy_process_group()


def worker(run: common.Run, rank: int, world: int, store: str):
    """Entry of ranks 1..: its traceback on standard error and exit code 1
    on failure."""
    if run.device.type == "cuda":
        run.device = torch.device("cuda", rank)
    try:
        _rank(run, rank, world, store)
    except BaseException:
        traceback.print_exc()
        raise SystemExit(1)


def run(run: common.Run) -> dict:
    world = common.traffic(run, "ranks")
    store = os.path.join(tempfile.gettempdir(),
                         f"port_bench_store_{os.getpid()}_{time.time_ns()}")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker, args=(run, k, world, store))
             for k in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = _rank(run, 0, world, store)
    except BaseException:
        traceback.print_exc()
        for p in procs:
            p.kill()
        raise
    finally:
        for p in procs:
            p.join(JOIN_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(store):
            os.unlink(store)
    bad = [k + 1 for k, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} failed (exit codes "
                           f"{[procs[k - 1].exitcode for k in bad]})")
    common.free(run.device)
    counts, r = out["counts"], out["r"]
    differ = int((counts != counts[-1]).sum())
    t_ref = time.perf_counter()
    values = common.frame_check(
        out["image"], int(counts[-1]), out["cols"], out["cam_spec"],
        out["draws"], r, out["seed"],
        run.cell["traffic"]["engine"] == "respawn", run.device)
    values["frames_differ"] = differ
    reference_s = time.perf_counter() - t_ref
    summary = out["summary"]
    if summary is not None:
        for k, e in enumerate(out["every"]):
            print(f"port_bench: rank {k} traced busy {e['busy_s']!r} s, "
                  f"busy but for the collectives {e['compute_s']!r} s, "
                  f"window {e['window_s']!r} s", file=sys.stderr)
        # busy_s and window_s over the cards, as the device reports them;
        # the rest (compute_s, the ops) rank 0's own.
        summary = dict(summary, rank0_window_s=summary["window_s"], **{
            k: sum(e[k] for e in out["every"]) / world
            for k in ("busy_s", "window_s")})
    return common.finish(
        values, run.cell["limits"], setup_s=out["setup_s"],
        window_s=out["window_s"], frames=len(counts),
        rays=int(counts.sum()), frame_rays=int(counts[-1]),
        attempted=len(counts), failed=differ, reference_s=reference_s,
        memory_peak_bytes=max(e["peak"] for e in out["every"]),
        trace=summary, rank_iters=out["iters"],
        shape={"pixels": r["width"] * r["height"], "spp": r["spp"],
               "max_bounces": r["max_bounces"], "real": out["n_real"],
               "rows": len(out["cols"]["radius"])})
