"""Wavefront radiance integrator (rays1bench_tpu/render/integrator.py;
reference: src/latest/rayweek1.cpp:515-536).

The reference's recursion becomes an iterative masked wavefront: the batch
advances one bounce per step (bounce_step, keyed on the absolute bounce
index, so a trace may resume at any bounce), dead lanes masked. With early
exit the loop stops once every lane is dead; the fixed-trip mode
(early_exit=False) runs all max_bounces+1 steps, as the gradient path
needs. A path's radiance is the product of its attenuations times the sky
on a miss, 0 if absorbed or depth-capped. Rays are counted per radiance
evaluation, bounces included (++td->out_num_rays, rayweek1.cpp:517).

Index mode (`hit_index`, and `topology` replay, which is index mode reading
recorded rows) splits each bounce's intersection in two: a gradient-free
winning row and hit flag, then the differentiable hit record rebuilt from
that row (render/intersect.hit_record_from_index). With `remat`, each
bounce after its index is run under torch.utils.checkpoint: the backward
rebuilds the O(N) chain from the bounce's saved inputs and its (idx, hit),
and never runs the sweep again.

soft_eps > 0 (cfg.soft_silhouette) runs the detached two-branch estimator
of the soft-silhouette renderer: a hit bounces off its sphere with
probability cover (the SILHOUETTE_P draw) or passes through it from the far
exit, keeping its direction. The topology replay rebuilds the soft fields
from the recorded rows without promoting again (promote=False).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from rays1bench_tpu_torch.core import rng as rng_mod
from rays1bench_tpu_torch.render.intersect import (closest_hit,
                                                   hit_record_from_index)
from rays1bench_tpu_torch.render.materials import scatter


def sky_color(dx, dy, dz):
    """Vertical sky gradient lerp(white, (0.5,0.7,1.0), 0.5*(dir.y+1))
    (rayweek1.cpp:530-534)."""
    t = 0.5 * (dy + 1.0)
    s = 1.0 - t
    return s + t * 0.5, s + t * 0.7, s + t * 1.0


def initial_state(ox, oy, oz, dx, dy, dz, alive, ray_id):
    """The state bounce_step carries: (ox, oy, oz, dx, dy, dz, ar, ag, ab,
    rr, rg, rb, alive, count) with unit attenuation, zero radiance and zero
    counts."""
    one, zero = torch.ones_like(ox), torch.zeros_like(ox)
    return (ox, oy, oz, dx, dy, dz, one, one, one, zero, zero, zero, alive,
            torch.zeros_like(ray_id, dtype=torch.int32))


def two_branch(rec, sx, sy, sz, mr, mg, mb, ok, dx, dy, dz, seed, ray_id,
               bounce):
    """The soft block of integrator._bounce_step: take = u < sg(cover)
    bounces off the sphere with weight cover / sg(cover), else the lane
    passes through from the far exit with its direction kept and weight
    (1 - cover) / sg(1 - cover), and is never absorbed. Both weights are 1
    in value; their derivative is the silhouette term. Returns ((hx, hy,
    hz) resume point, (sx, sy, sz), (mr, mg, mb), ok, take)."""
    u = rng_mod.uniform01(seed, ray_id, bounce, rng_mod.Slots.SILHOUETTE_P)
    cov_sg = rec.cover.detach()
    take = u < cov_sg
    w_b = rec.cover / torch.clamp_min(cov_sg, 1e-20)
    w_t = (1.0 - rec.cover) / torch.clamp_min(1.0 - cov_sg, 1e-20)
    return ((torch.where(take, rec.px, rec.px2),
             torch.where(take, rec.py, rec.py2),
             torch.where(take, rec.pz, rec.pz2)),
            (torch.where(take, sx, dx), torch.where(take, sy, dy),
             torch.where(take, sz, dz)),
            (torch.where(take, mr * w_b, w_t), torch.where(take, mg * w_b, w_t),
             torch.where(take, mb * w_b, w_t)),
            (take & ok) | ~take, take)


def bounce_step(state, bounce: int, seed, ray_id, max_bounces: int,
                intersect, soft_eps: float = 0.0):
    """Advance every live lane by one bounce at absolute index `bounce`
    (integrator._bounce_step): count the live lanes, intersect, add the
    attenuated sky on a miss, scatter (and, with soft_eps, the two-branch
    draw), and continue while the depth allows (rayweek1.cpp:523).
    intersect(ox..dz) -> HitRecord, with the soft fields when soft_eps > 0.
    Returns the next state."""
    (ox, oy, oz, dx, dy, dz, ar, ag, ab, rr, rg, rb, alive, count) = state
    count = count + alive.to(torch.int32)
    rec = intersect(ox, oy, oz, dx, dy, dz)

    # Miss -> attenuated sky, lane dies.
    skr, skg, skb = sky_color(dx, dy, dz)
    miss = alive & ~rec.hit
    rr = rr + torch.where(miss, ar * skr, 0.0)
    rg = rg + torch.where(miss, ag * skg, 0.0)
    rb = rb + torch.where(miss, ab * skb, 0.0)

    (sx, sy, sz), (mr, mg, mb), ok = scatter(dx, dy, dz, rec, seed, ray_id,
                                             bounce)
    hx, hy, hz = rec.px, rec.py, rec.pz
    if soft_eps:
        (hx, hy, hz), (sx, sy, sz), (mr, mg, mb), ok, _ = two_branch(
            rec, sx, sy, sz, mr, mg, mb, ok, dx, dy, dz, seed, ray_id, bounce)
    cont = alive & rec.hit & ok & (bounce < max_bounces)
    return (torch.where(cont, hx, ox), torch.where(cont, hy, oy),
            torch.where(cont, hz, oz), torch.where(cont, sx, dx),
            torch.where(cont, sy, dy), torch.where(cont, sz, dz),
            torch.where(cont, ar * mr, ar), torch.where(cont, ag * mg, ag),
            torch.where(cont, ab * mb, ab), rr, rg, rb, cont, count)


def _indexed_step(state, bounce, seed, ray_id, max_bounces, spheres, t_min,
                  idx, hit, soft_eps, promote):
    return bounce_step(
        state, bounce, seed, ray_id, max_bounces,
        lambda *r: hit_record_from_index(*r, spheres, idx, hit, t_min,
                                         soft_eps=soft_eps, promote=promote),
        soft_eps)


def trace(spheres, ox, oy, oz, dx, dy, dz, seed, ray_id,
          max_bounces: int = 50, t_min: float = 1e-3, t_max: float = 3.4e38,
          early_exit: bool = True, active=None, intersector=None,
          topology=None, hit_index=None, remat: bool = False,
          soft_eps: float = 0.0):
    """Trace a wavefront of N primary rays to completion.

    active: optional bool[N]; inactive lanes are dead from the start and are
    never counted. intersector(ox..dz) -> HitRecord replaces the plain
    closest_hit sweep over `spheres` (the megakernel's plain version passes
    its packed-table sweep). hit_index(ox..dz) -> (idx int[N], hit bool[N])
    gives each bounce's winning row instead, and the hit record is rebuilt
    from it (index mode). topology = (idx int[max_bounces+1, N], hit
    bool[max_bounces+1, N]) replays recorded winners the same way; it needs
    early_exit=False. remat (index mode, under autograd): checkpoint each
    bounce after its index, so only the bounce's inputs and (idx, hit) stay
    saved for the backward. soft_eps > 0: the soft-silhouette renderer; the
    plain sweep and index mode promote near misses, the topology replay
    does not (its rows are already promoted), and a given intersector must
    return the soft fields itself.

    Returns ((rr, rg, rb) float32[N] radiance, count int32[N] rays traced per
    lane). The JAX counterpart returns only the summed count."""
    if topology is not None:
        if early_exit:
            raise ValueError("topology replay is fixed-trip: pass "
                             "early_exit=False")
        topo_idx, topo_hit = topology
    elif hit_index is None and intersector is None:
        intersector = lambda *r: closest_hit(*r, spheres, t_min, t_max,
                                             soft_eps)
    alive = torch.ones_like(ox, dtype=torch.bool) if active is None else active
    state = initial_state(ox, oy, oz, dx, dy, dz, alive, ray_id)
    remat = remat and torch.is_grad_enabled()

    for bounce in range(max_bounces + 1):
        if early_exit and not bool(state[12].any()):
            break
        if topology is None and hit_index is None:
            state = bounce_step(state, bounce, seed, ray_id, max_bounces,
                                intersector, soft_eps)
            continue
        if topology is None:
            idx, hit = hit_index(*state[:6])
        else:
            idx, hit = topo_idx[bounce], topo_hit[bounce]
        args = (state, bounce, seed, ray_id, max_bounces, spheres, t_min,
                idx, hit, soft_eps, topology is None)
        state = (checkpoint(_indexed_step, *args, use_reentrant=False,
                            preserve_rng_state=False)
                 if remat else _indexed_step(*args))

    return state[9:12], state[13]
