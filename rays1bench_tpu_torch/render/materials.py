"""Branchless material scatter (rays1bench_tpu/render/materials.py;
reference: src/latest/rayweek1.cpp:396-512).

All three material responses are computed over the whole wavefront and
selected by the integer mat_type column:
  Lambertian (rayweek1.cpp:396-412): target = p + n + ball; always scatters.
  Metal     (rayweek1.cpp:419-437): mirror + fuzz*ball; absorbed when the
            scattered direction leaves through the surface.
  Dielectric (rayweek1.cpp:461-512): reflect/refract with Schlick probability.
"""

from __future__ import annotations

import torch

from rays1bench_tpu_torch.core import rng as rng_mod
from rays1bench_tpu_torch.core.vecmath import dot3, normalize3, reflect3, safe_sqrt
from rays1bench_tpu_torch.render.intersect import HitRecord
from rays1bench_tpu_torch.scene.spheres import DIELECTRIC, METAL


def scatter(dx, dy, dz, rec: HitRecord, seed, ray_id, bounce):
    """Scatter the wavefront at its hit points.

    dx, dy, dz: incoming unit directions; seed, ray_id, bounce: RNG lattice
    coordinates (bounce may be per lane). Returns ((sx, sy, sz) unit
    scattered directions, (ar, ag, ab) attenuation, ok bool[N] False where
    the ray is absorbed)."""
    nx, ny, nz = rec.nx, rec.ny, rec.nz

    bx, by, bz = rng_mod.in_unit_ball(seed, ray_id, bounce,
                                      rng_mod.Slots.SCATTER_BALL)

    # Lambertian: normalize(n + ball).
    lx, ly, lz = normalize3(nx + bx, ny + by, nz + bz)

    # Metal: reflect + fuzz * ball.
    rx, ry, rz = reflect3(dx, dy, dz, nx, ny, nz)
    mx, my, mz = normalize3(rx + rec.fuzz * bx,
                            ry + rec.fuzz * by,
                            rz + rec.fuzz * bz)
    metal_ok = dot3(mx, my, mz, nx, ny, nz) > 0.0

    # Dielectric: outward normal, eta ratio, cosine (rayweek1.cpp:479-490).
    d_dot_n = dot3(dx, dy, dz, nx, ny, nz)
    exiting = d_dot_n > 0.0
    onx = torch.where(exiting, -nx, nx)
    ony = torch.where(exiting, -ny, ny)
    onz = torch.where(exiting, -nz, nz)
    ri = rec.ref_idx
    ni_over_nt = torch.where(exiting, ri, 1.0 / ri)
    cosine = torch.where(exiting, ri * d_dot_n, -d_dot_n)
    # Refract (rayweek1.cpp:439-452). The trailing normalize is load-bearing:
    # n = (p - c) * inv_radius carries the t-solve's cancellation error
    # (~1e-4 on the r=100 ground sphere), which otherwise compounds through
    # deep glass chains (+0.48% rays on the large scene at 250 spp / 50
    # bounces, rays1bench_tpu/render/materials.py:65-81).
    dt = dot3(dx, dy, dz, onx, ony, onz)
    refr_disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    can_refract = refr_disc > 0.0
    rd = safe_sqrt(refr_disc)
    fx = ni_over_nt * (dx - onx * dt) - onx * rd
    fy = ni_over_nt * (dy - ony * dt) - ony * rd
    fz = ni_over_nt * (dz - onz * dt) - onz * rd
    fx, fy, fz = normalize3(fx, fy, fz)
    # Schlick (rayweek1.cpp:454-459).
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    one_c = 1.0 - cosine
    one_c2 = one_c * one_c
    schlick_p = r0 + (1.0 - r0) * one_c2 * one_c2 * one_c
    reflect_prob = torch.where(can_refract, schlick_p, 1.0)
    u = rng_mod.uniform01(seed, ray_id, bounce, rng_mod.Slots.DIELECTRIC_P)
    take_reflect = u < reflect_prob
    gx = torch.where(take_reflect, rx, fx)
    gy = torch.where(take_reflect, ry, fy)
    gz = torch.where(take_reflect, rz, fz)

    is_metal = rec.mat_type == METAL
    is_diel = rec.mat_type == DIELECTRIC
    sx = torch.where(is_diel, gx, torch.where(is_metal, mx, lx))
    sy = torch.where(is_diel, gy, torch.where(is_metal, my, ly))
    sz = torch.where(is_diel, gz, torch.where(is_metal, mz, lz))

    # Dielectric attenuation is (1,1,1) (rayweek1.cpp:470); its albedo
    # columns hold 1. Only metals absorb (rayweek1.cpp:433).
    ok = metal_ok | ~is_metal
    return (sx, sy, sz), (rec.albedo_x, rec.albedo_y, rec.albedo_z), ok
