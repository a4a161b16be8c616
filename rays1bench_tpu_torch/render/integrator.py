"""Wavefront radiance integrator (rays1bench_tpu/render/integrator.py;
reference: src/latest/rayweek1.cpp:515-536).

The reference's recursion becomes an iterative masked wavefront: the batch
advances one bounce per step, dead lanes masked. With early exit the loop
stops once every lane is dead; the fixed-trip mode (early_exit=False) runs
all max_bounces+1 steps, as the gradient path needs. A path's radiance is
the product of its attenuations times the sky on a miss, 0 if absorbed or
depth-capped. Rays are counted per radiance evaluation, bounces included
(++td->out_num_rays, rayweek1.cpp:517).

Topology replay (`topology=(idx, hit)`) rebuilds every bounce's
differentiable hit record from a recorded winning row instead of sweeping:
the backward half of the megakernel-forward gradient (grad/mega.py). The
JAX package's soft-silhouette mode is not ported.
"""

from __future__ import annotations

import torch

from rays1bench_tpu_torch.render.intersect import (closest_hit,
                                                   hit_record_from_index)
from rays1bench_tpu_torch.render.materials import scatter


def sky_color(dx, dy, dz):
    """Vertical sky gradient lerp(white, (0.5,0.7,1.0), 0.5*(dir.y+1))
    (rayweek1.cpp:530-534)."""
    t = 0.5 * (dy + 1.0)
    s = 1.0 - t
    return s + t * 0.5, s + t * 0.7, s + t * 1.0


def trace(spheres, ox, oy, oz, dx, dy, dz, seed, ray_id,
          max_bounces: int = 50, t_min: float = 1e-3, t_max: float = 3.4e38,
          early_exit: bool = True, active=None, intersector=None,
          topology=None):
    """Trace a wavefront of N primary rays to completion.

    active: optional bool[N]; inactive lanes are dead from the start and are
    never counted. intersector(ox..dz) -> HitRecord replaces the plain
    closest_hit sweep over `spheres` (the megakernel's plain version passes
    its packed-table sweep). topology = (idx int[max_bounces+1, N], hit
    bool[max_bounces+1, N]) replays the recorded winners through
    hit_record_from_index instead; it needs early_exit=False.

    Returns ((rr, rg, rb) float32[N] radiance, count int32[N] rays traced per
    lane). The JAX counterpart returns only the summed count."""
    if topology is not None:
        if early_exit:
            raise ValueError("topology replay is fixed-trip: pass "
                             "early_exit=False")
        topo_idx, topo_hit = topology
    elif intersector is None:
        intersector = lambda *r: closest_hit(*r, spheres, t_min, t_max)
    alive = torch.ones_like(ox, dtype=torch.bool) if active is None else active
    ar = torch.ones_like(ox)
    ag = torch.ones_like(ox)
    ab = torch.ones_like(ox)
    rr = torch.zeros_like(ox)
    rg = torch.zeros_like(ox)
    rb = torch.zeros_like(ox)
    count = torch.zeros_like(ray_id, dtype=torch.int32)

    for bounce in range(max_bounces + 1):
        if early_exit and not bool(alive.any()):
            break
        count += alive.to(torch.int32)
        if topology is None:
            rec = intersector(ox, oy, oz, dx, dy, dz)
        else:
            rec = hit_record_from_index(ox, oy, oz, dx, dy, dz, spheres,
                                        topo_idx[bounce], topo_hit[bounce],
                                        t_min)

        # Miss -> attenuated sky, lane dies.
        skr, skg, skb = sky_color(dx, dy, dz)
        miss = alive & ~rec.hit
        rr = rr + torch.where(miss, ar * skr, 0.0)
        rg = rg + torch.where(miss, ag * skg, 0.0)
        rb = rb + torch.where(miss, ab * skb, 0.0)

        # Hit -> scatter while depth allows (rayweek1.cpp:523).
        (sx, sy, sz), (mr, mg, mb), ok = scatter(dx, dy, dz, rec, seed,
                                                 ray_id, bounce)
        cont = alive & rec.hit & ok & (bounce < max_bounces)
        ox = torch.where(cont, rec.px, ox)
        oy = torch.where(cont, rec.py, oy)
        oz = torch.where(cont, rec.pz, oz)
        dx = torch.where(cont, sx, dx)
        dy = torch.where(cont, sy, dy)
        dz = torch.where(cont, sz, dz)
        ar = torch.where(cont, ar * mr, ar)
        ag = torch.where(cont, ag * mg, ag)
        ab = torch.where(cont, ab * mb, ab)
        alive = cont

    return (rr, rg, rb), count
