"""Failed gradient checks, kept and replayed; and a probe that looks for them
on the soft geometry fit.

    python -m rays1bench_tpu_torch.bench.gradcase --fits 12 \\
        --out tmp/grad_cases [--replay CASE_DIR ...]

`save_case` writes what a check of the fused backward against
backward_reference needs to run again: the SphereSOA columns and the
per-ray radiance cotangents as .npy, the RenderConfig, the scene whose
camera made the primary rays (render/pipeline.primary_rays_from_ids at
cfg), the seeds, and the ids of a ray list where the check ran on one.
`load_case` reads it back on any device. chip_smoke.py saves every
gradient check that fails.

The probe (main) runs the full-resolution soft geometry fit
(tools/fullres_fit_probe.py:55-75, as chip_smoke.py's soft_fit: small
scene, 1280x720 @ 4 spp @ 10 b, seed 3, soft 0.005, 150 Adam steps) --fits
times. The fitted scene differs from fit to fit, since the backward adds
its column sums with float atomics in an order that changes from run to
run. On each fitted scene it holds the fused backward against
backward_reference over the whole frame (cotangents from random_cts' seed
2, as chip_smoke.py's full_width), on the columns chip_smoke.py checks
(every GRAD_ROWS column but the raw inv_radius one, the six ray planes and
the scene's own columns chained through prepare), and prints per fit: the
worst relative gap (max abs gap over the column's max abs value) and its
column; the same gap between two launches of the kernel on the same inputs
(the atomics' order alone); the same gap between the plain version summed
in chunks of 2^19 and of 2^16 rays; and, where the worst column is a
GRAD_ROWS one, its cancellation at the row of the worst gap: the sum over
the 2^16-ray chunks of |chunk sum| over |sum|. A fit whose worst gap
exceeds --keep is saved under --out, and its worst row is then split by
ray chunks, kernel against plain version chunk by chunk, down to the chunk
of 32 rays that holds the largest share of the gap. Each fit also prints
the worst gap over the columns' summed scale (summed_scales), the measure
chip_smoke.py checks whole-frame column sums against. --replay checks
saved whole-frame cases again first (replay). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from rays1bench_tpu_torch.bench.grad import GEOMETRY, geometry_config, \
    moved_geometry
from rays1bench_tpu_torch.bench.profile import smi
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad.inverse import fit_scene, render_for_loss
from rays1bench_tpu_torch.kernels import mega_backward, megakernel
from rays1bench_tpu_torch.kernels.pipeline import frame_ray_ids
from rays1bench_tpu_torch.render.pipeline import primary_rays_from_ids
from rays1bench_tpu_torch.scene import builders, convert
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS
from rays1bench_tpu_torch.scene.spheres import prepare

SOFT = 0.005
SOFT_FIT = dict(width=1280, height=720, spp=4, max_bounces=10,
                seed=GEOMETRY["small"][0], early_exit=False,
                soft_silhouette=SOFT)
FIT_STEPS = 150
COTANGENT_SEED = 2
CHUNKS = (1 << 19, 1 << 16)


def save_case(out_dir, label, scene_name, soa, cfg, cts, cts_seed,
              ray_ids=None):
    """Write one gradient check's inputs into a new directory under
    out_dir; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    d = tempfile.mkdtemp(prefix="case_", dir=out_dir)
    for c in COLUMNS:
        np.save(os.path.join(d, f"soa_{c}.npy"),
                getattr(soa, c).detach().cpu().numpy())
    for name, t in zip(("ct_r", "ct_g", "ct_b"), cts):
        np.save(os.path.join(d, f"{name}.npy"), t.detach().cpu().numpy())
    if ray_ids is not None:
        np.save(os.path.join(d, "ray_id.npy"), ray_ids.cpu().numpy())
    with open(os.path.join(d, "case.json"), "w") as f:
        json.dump({"label": label, "scene": scene_name,
                   "config": dataclasses.asdict(cfg), "seed": cfg.seed,
                   "cotangent_seed": cts_seed}, f, indent=1)
    return d


def load_case(d, device):
    """(scene name, SphereSOA, RenderConfig, [ct_r, ct_g, ct_b], ray ids or
    None) of a saved case, on device."""
    with open(os.path.join(d, "case.json")) as f:
        meta = json.load(f)
    cfg = RenderConfig(**meta["config"])
    soa = convert.soa_from_numpy(
        {c: np.load(os.path.join(d, f"soa_{c}.npy")) for c in COLUMNS},
        device)
    cts = [torch.from_numpy(np.load(os.path.join(d, f"{n}.npy"))).to(device)
           for n in ("ct_r", "ct_g", "ct_b")]
    ids = os.path.join(d, "ray_id.npy")
    ray_ids = (torch.from_numpy(np.load(ids)).to(device)
               if os.path.exists(ids) else None)
    return meta["scene"], soa, cfg, cts, ray_ids


def frame_rays(scene_name, cfg, device):
    """Every primary ray of cfg's frame through the scene's camera, in
    ray-id order: (rays, ray ids)."""
    camera = builders.SCENES[scene_name](cfg.aspect,
                                         device=device).camera.build(device)
    ray_id = frame_ray_ids(cfg, device)
    return ([r.contiguous() for r in primary_rays_from_ids(camera, cfg,
                                                           ray_id)], ray_id)


def random_cts(n, seed, device="cuda"):
    """Per-ray radiance cotangents, uniform in [-0.5, 0.5), from a seed (as
    chip_smoke.py draws them)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.rand(n, generator=g, device=device) - 0.5
            for _ in range(3)]


def soa_grads(soa, grads):
    """GRAD_ROWS cotangents chained onto the scene's float columns through
    scene/spheres.prepare (what a fit's parameters receive)."""
    floats = [c for c in COLUMNS if c != "mat_type"]
    soa = dataclasses.replace(soa, **{
        c: getattr(soa, c).detach().clone().requires_grad_(True)
        for c in floats})
    prep = prepare(soa)
    torch.autograd.backward(
        [getattr(prep, n) for n in mega_backward.GRAD_ROWS], list(grads))
    return [getattr(soa, c).grad for c in floats]


def soft_columns(soa, grads, ray_cts):
    """{name: tensor} of what the soft check compares: the GRAD_ROWS
    columns but inv_radius, the six ray planes, the scene's own columns."""
    out = {f"grad {n}": grads[k] for k, n in
           enumerate(mega_backward.GRAD_ROWS) if n != "inv_radius"}
    out.update({f"ray {n}": t for n, t in
                zip(("ox", "oy", "oz", "dx", "dy", "dz"), ray_cts)})
    floats = [c for c in COLUMNS if c != "mat_type"]
    out.update({f"scene {c}": g for c, g in
                zip(floats, soa_grads(soa, grads))})
    return out


def summed_scales(soa, chunks):
    """{name: sum over chunks of |chunk value|} for the summed columns of
    soft_columns (GRAD_ROWS and scene columns), given the per-chunk grads
    of the plain version; None for the per-ray planes. A column sum's
    float32 rounding scales with the magnitudes of its terms, not with the
    sum: where the terms cancel, the same accuracy on every ray shows as a
    larger gap over |sum|. This is a lower bound of that scale, and at
    least |sum|."""
    per = [soft_columns(soa, c, [None] * 6) for c in chunks]
    return {n: (None if n.startswith("ray ") else
                sum(q[n].abs() for q in per)) for n in per[0]}


def rel_gaps(a, b, scales=None):
    """{name: max |a - b| / max |b|} over the columns of two soft_columns,
    or over the column's summed scale where `scales` gives one."""
    den = lambda n: (b[n].abs() if scales is None or scales[n] is None
                     else scales[n]).max().clamp_min(1e-30)
    return {n: float((a[n] - b[n]).abs().max() / den(n)) for n in a}


def plain_backward(prep, rays, ray_id, cts, topo, cfg, chunk):
    """backward_reference over the frame in chunks of rays, column sums
    added chunk by chunk: (grads, ray cotangents, [per-chunk grads])."""
    n = ray_id.numel()
    parts = [mega_backward.backward_reference(
        prep, *(r[lo:lo + chunk] for r in rays), ray_id[lo:lo + chunk],
        *(c[lo:lo + chunk] for c in cts), topo[:, lo:lo + chunk], cfg)
        for lo in range(0, n, chunk)]
    return (sum(q[0] for q in parts),
            [torch.cat([q[1][c] for q in parts]) for c in range(6)],
            [q[0] for q in parts])


def split_row(prep, rays, ray_id, cts, topo, cfg, g_row, col):
    """Kernel against plain version on chunks of rays: the range splits
    into 8 chunks, and the chunk with the largest gap in grads[g_row, col]
    splits again, down to 32 rays; returns
    [(first ray, rays, chunk gap, gap of the whole range)]."""
    lo, n, path = 0, ray_id.numel(), []
    while True:
        size = max(32, -(-n // 8))
        best = None
        whole = 0.0
        for a in range(lo, lo + n, size):
            sl = slice(a, min(a + size, lo + n))
            args = ([r[sl].contiguous() for r in rays], ray_id[sl].contiguous(),
                    [c[sl].contiguous() for c in cts], topo[:, sl].contiguous())
            k, _ = mega_backward.backward(prep, *args[0], args[1], *args[2],
                                          args[3], cfg)
            p, _ = mega_backward.backward_reference(prep, *args[0], args[1],
                                                    *args[2], args[3], cfg)
            gap = float((k[g_row, col] - p[g_row, col]).abs())
            whole += gap
            if best is None or gap > best[2]:
                best = (a, sl.stop - a, gap)
        path.append(best + (whole,))
        if best[1] <= 32:
            return path
        lo, n = best[0], best[1]


def probe_fit(k, args, scene, camera, target):
    cfg = RenderConfig(**SOFT_FIT)
    fitted, _ = fit_scene(moved_geometry(scene.spheres, "small"), camera,
                          target, cfg, geometry_config("small", FIT_STEPS),
                          engine="mega")
    prep = prepare(fitted)
    rays, ray_id = frame_rays("small", cfg, "cuda")
    _, _, _, topo = megakernel.trace_topology(megakernel.pack_spheres(prep),
                                              *rays, ray_id, cfg)
    cts = random_cts(ray_id.numel(), COTANGENT_SEED)
    runs = [mega_backward.backward(prep, *rays, ray_id, *cts, topo, cfg)
            for _ in range(2)]
    plains = [plain_backward(prep, rays, ray_id, cts, topo, cfg, c)
              for c in CHUNKS]
    kcols = [soft_columns(fitted, *r) for r in runs]
    pcols = [soft_columns(fitted, *p[:2]) for p in plains]
    gap = rel_gaps(kcols[0], pcols[0])
    worst = max(gap, key=gap.get)
    self_gap = max(rel_gaps(kcols[1], kcols[0]).values())
    plain_gap = max(rel_gaps(pcols[1], pcols[0]).values())
    scaled = rel_gaps(kcols[0], pcols[0], summed_scales(fitted, plains[0][2]))
    line = {"fit": k, "worst_gap": gap[worst], "column": worst,
            "kernel_vs_kernel": self_gap, "plain_vs_plain": plain_gap,
            "worst_gap_over_summed_scale": max(scaled.values())}
    if worst.startswith("grad "):
        g_row = mega_backward.GRAD_ROWS.index(worst[5:])
        col = int((kcols[0][worst] - pcols[0][worst]).abs().argmax())
        line.update(row=col, cancellation=float(
            sum(q[g_row, col].abs() for q in plains[1][2])
            / pcols[0][worst][col].abs().clamp_min(1e-30)))
    print(f"[gradcase] {json.dumps(line)}", flush=True)
    if gap[worst] > args.keep:
        d = save_case(args.out, f"soft fit {k}, whole frame", "small",
                      fitted, cfg, cts, COTANGENT_SEED)
        print(f"[gradcase] fit {k}: kept in {d}", flush=True)
        if "row" in line:
            for step in split_row(prep, rays, ray_id, cts, topo, cfg, g_row,
                                  line["row"]):
                print(f"[gradcase] fit {k}: rays {step[0]}..{step[0] + step[1]}"
                      f" hold {step[2]:.3e} of the range's summed chunk gaps "
                      f"{step[3]:.3e}", flush=True)
    return gap[worst]


def replay(d):
    """A saved whole-frame case again: per column, the kernel's gap to the
    plain version over max |sum| and over the summed scale, and at the worst
    column's worst row the kernel's and the plain version's sums, the
    summed scale and the largest chunk sum."""
    scene_name, soa, cfg, cts, _ = load_case(d, "cuda")
    prep = prepare(soa)
    rays, ray_id = frame_rays(scene_name, cfg, "cuda")
    _, _, _, topo = megakernel.trace_topology(megakernel.pack_spheres(prep),
                                              *rays, ray_id, cfg)
    k = soft_columns(soa, *mega_backward.backward(prep, *rays, ray_id, *cts,
                                                  topo, cfg))
    plain = plain_backward(prep, rays, ray_id, cts, topo, cfg, CHUNKS[0])
    p = soft_columns(soa, *plain[:2])
    scales = summed_scales(soa, plain[2])
    over_sum, over_scale = rel_gaps(k, p), rel_gaps(k, p, scales)
    for n in k:
        print(f"[gradcase] replay {d}: {n}: gap over max |sum| "
              f"{over_sum[n]:.3e}, over the summed scale {over_scale[n]:.3e}",
              flush=True)
    worst = max(over_sum, key=over_sum.get)
    row = int((k[worst] - p[worst]).abs().argmax())
    chunk = max((float(q[mega_backward.GRAD_ROWS.index(worst[5:]), row])
                 for q in plain[2]), key=abs) if worst.startswith("grad ") \
        else None
    print(f"[gradcase] replay {d}: worst {worst} row {row}: kernel "
          f"{float(k[worst][row])!r}, plain {float(p[worst][row])!r}, summed "
          f"scale {float(scales[worst][row]) if scales[worst] is not None else None!r}, "
          f"largest chunk sum {chunk!r} ({CHUNKS[0]} rays a chunk)",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fits", type=int, default=12)
    ap.add_argument("--keep", type=float, default=2e-4,
                    help="save fits whose worst relative gap exceeds this")
    ap.add_argument("--out", default="tmp/grad_cases")
    ap.add_argument("--replay", nargs="*", default=[],
                    help="saved case directories to check again first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench.gradcase needs a CUDA device")
    print(f"[gradcase] card {smi('name', 'power.limit')[0]}", flush=True)
    for d in args.replay:
        replay(d)
    cfg = RenderConfig(**SOFT_FIT)
    scene = builders.SCENES["small"](cfg.aspect, pad_multiple=8,
                                     device="cuda")
    camera = scene.camera.build("cuda")
    with torch.no_grad():
        target = render_for_loss(scene.spheres, camera, cfg, engine="mega")
    worst = [probe_fit(k, args, scene, camera, target)
             for k in range(args.fits)]
    print(f"[gradcase] {args.fits} fitted scenes, worst relative gap "
          f"{max(worst):.3e}, kept {sum(w > args.keep for w in worst)}",
          flush=True)


if __name__ == "__main__":
    main()
