"""Closest-hit ray/sphere intersection, plain version
(rays1bench_tpu/render/intersect.py; reference:
src/latest/rayweek1.cpp:152-339).

The reference's two-pass compaction becomes a dense masked sweep over the
(rays x spheres) candidate matrix and a first-minimum argmin; the hit record
is then recomputed from the winning row by hit_record_from_index, which the
gradient path's topology replay calls directly. Normalized ray directions
are assumed. With soft_eps > 0 (cfg.soft_silhouette) a ray grazing a sphere
in front of its hit is promoted to a soft hit of it (_near_miss_index), and
the record gains the soft fields: the cover of the silhouette's sigmoid and
the far exit where a pass-through resumes.

take_cols is a plain clamped index on this port. The JAX package runs it as
a dense select sweep with a one-hot custom VJP, because TPU gathers and
scatters serialize per element (rays1bench_tpu/render/intersect.py:41-94);
on a GPU an index is cheap and autograd's index backward is the scatter-add.
"""

from __future__ import annotations

import dataclasses

import torch

from rays1bench_tpu_torch.core.vecmath import f32, safe_sqrt, sigmoid, sqrt
from rays1bench_tpu_torch.scene.spheres import PreparedSpheres

_BIG = 3.0e38


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Planar hit payload (HitRecord, rayweek1.cpp:122-128, plus the material
    columns that replace the Material* pointer)."""
    hit: torch.Tensor        # bool[N]
    t: torch.Tensor          # float32[N]
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    mat_type: torch.Tensor   # int32[N]
    albedo_x: torch.Tensor
    albedo_y: torch.Tensor
    albedo_z: torch.Tensor
    fuzz: torch.Tensor
    ref_idx: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SoftHitRecord(HitRecord):
    """HitRecord of the soft renderer (soft_eps > 0) with its soft fields:
    cover in (0, 1), and the winning sphere's far exit, where a
    pass-through resumes. The JAX HitRecord carries them as fields that
    are None in hard mode."""
    cover: torch.Tensor
    px2: torch.Tensor
    py2: torch.Tensor
    pz2: torch.Tensor


def closest_hit_index(ox, oy, oz, dx, dy, dz, spheres: PreparedSpheres,
                      t_min: float, t_max: float):
    """(best int64[N], hit bool[N]): the first row with the smallest root in
    (t_min, t_max), over all S rows at once."""
    cox = spheres.center_x - ox[:, None]
    coy = spheres.center_y - oy[:, None]
    coz = spheres.center_z - oz[:, None]
    nb = cox * dx[:, None] + coy * dy[:, None] + coz * dz[:, None]
    c = cox * cox + coy * coy + coz * coz - spheres.radius_sq
    discr = nb * nb - c

    can_hit = (discr > 0.0) & (spheres.valid > 0.0)
    sq = sqrt(torch.where(can_hit, discr, 0.0))
    t1 = nb - sq
    t2 = nb + sq
    # The reference tries the near root first, then the far one
    # (rayweek1.cpp:297-313).
    t_cand = torch.where(t1 > t_min, t1, t2)
    ok = can_hit & (t_cand > t_min) & (t_cand < t_max)
    t_masked = torch.where(ok, t_cand, _BIG)
    t_best, best = torch.min(t_masked, dim=1)  # first minimum wins
    return best, t_best < _BIG


def take_cols(cols, j):
    """cols[:, j] for (C, S) columns and int[N] row indices -> (C, N).
    j = -1 (a dead lane of the topology replay) reads column 0, which every
    consumer masks with hit=False."""
    return cols[:, j.clamp(min=0).long()]


def closest_hit(ox, oy, oz, dx, dy, dz, spheres: PreparedSpheres,
                t_min: float, t_max: float, soft_eps: float = 0.0) -> HitRecord:
    """Closest intersection of N rays against all S spheres: the index sweep,
    then an O(N) recompute of t, point and normal from the winning row (and,
    with soft_eps, the near-miss promotion and the soft fields)."""
    best, hit = closest_hit_index(ox, oy, oz, dx, dy, dz, spheres,
                                  t_min, t_max)
    return hit_record_from_index(ox, oy, oz, dx, dy, dz, spheres, best, hit,
                                 t_min, soft_eps=soft_eps)


# Half-width of the near-miss band in units of soft_eps: a lane with edge
# coordinate in (-_NEAR_CUT * soft_eps, 0] gets a cover term. At the cut,
# cover = sigmoid(-9.2) ~ 1e-4.
_NEAR_CUT = 9.2


def near_cut(soft_eps: float) -> float:
    """The promotion threshold -_NEAR_CUT * soft_eps as a float32 value."""
    return f32(-_NEAR_CUT * soft_eps)


def _near_miss_index(ox, oy, oz, dx, dy, dz, spheres: PreparedSpheres,
                     hit, best, t_min: float, soft_eps: float):
    """Best near miss per ray (intersect._near_miss_index): the first row
    with the largest edge = |r| - b among valid rows the ray misses (edge <=
    0) whose closest approach nb lies in (t_min, t of the current hit).
    Topology only, so every input is detached.

    Returns (j_near int64[N], near bool[N]): near marks lanes whose best
    edge is above -_NEAR_CUT * soft_eps."""
    ox, oy, oz, dx, dy, dz = (v.detach() for v in (ox, oy, oz, dx, dy, dz))
    cx, cy, cz, rsq = (v.detach() for v in (
        spheres.center_x, spheres.center_y, spheres.center_z,
        spheres.radius_sq))
    cox = cx - ox[:, None]
    coy = cy - oy[:, None]
    coz = cz - oz[:, None]
    nb = cox * dx[:, None] + coy * dy[:, None] + coz * dz[:, None]
    co2 = cox * cox + coy * coy + coz * coz
    edge = (sqrt(torch.clamp_min(rsq, 0.0))
            - sqrt(torch.clamp_min(co2 - nb * nb, 1e-20)))

    # t of the current hit (+BIG on a miss), from the winning row.
    c0x, c0y, c0z, rsq0 = take_cols(torch.stack([cx, cy, cz, rsq]), best)
    g0x, g0y, g0z = c0x - ox, c0y - oy, c0z - oz
    nb0 = g0x * dx + g0y * dy + g0z * dz
    c0 = g0x * g0x + g0y * g0y + g0z * g0z - rsq0
    sq0 = safe_sqrt(nb0 * nb0 - c0)
    t10 = nb0 - sq0
    t_hit = torch.where(hit, torch.where(t10 > t_min, t10, nb0 + sq0), _BIG)

    graze = ((spheres.valid > 0.0) & (nb > t_min) & (edge <= 0.0)
             & (nb < t_hit[:, None]))
    score = torch.where(graze, edge, -_BIG)
    best_edge, j_near = torch.max(score, dim=1)  # first maximum wins
    return j_near, best_edge > near_cut(soft_eps)


def soft_fields(ox, oy, oz, dx, dy, dz, rsq, nb, c, sq, nx, ny, nz,
                soft_eps: float):
    """The soft record's part of a hit on a row with radius_sq rsq, where
    nb = (center - o).d, c = |center - o|^2 - rsq, sq = safe_sqrt(nb^2 - c)
    and (nx, ny, nz) = (p - center) * inv_radius. Returns (the normal
    renormalized with IEEE 1 / sqrt, a promoted lane's point lying just
    outside the sphere; dict(cover, px2, py2, pz2)): cover = sigmoid(edge /
    soft_eps) with edge = |r| - b in world units, b^2 = c + rsq - nb^2 (the
    ray line's distance to the center squared), and the far exit
    o + (nb + sq) d."""
    b = sqrt(torch.clamp_min(c + rsq - nb * nb, 1e-20))
    edge = sqrt(torch.clamp_min(rsq, 0.0)) - b
    t2 = nb + sq
    inv_len = 1.0 / sqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-20))
    return ((nx * inv_len, ny * inv_len, nz * inv_len),
            dict(cover=sigmoid(edge * f32(1.0 / soft_eps)), px2=ox + t2 * dx,
                 py2=oy + t2 * dy, pz2=oz + t2 * dz))


def hit_record_from_index(ox, oy, oz, dx, dy, dz, spheres: PreparedSpheres,
                          best, hit, t_min: float, soft_eps: float = 0.0,
                          promote: bool = True) -> HitRecord:
    """Differentiable hit record of the given winning rows.

    best: int[N] row per ray (-1 reads row 0, masked by hit); hit: bool[N].
    Gradients flow through t, point, normal and the material columns at the
    fixed index; mat_type rides the float stack and leaves it detached.

    soft_eps > 0: lanes grazing a sphere in front of their hit
    (_near_miss_index) are promoted to soft hits of it, unless promote is
    False: the topology replay, whose rows come from a soft forward that
    already promoted. Then the record gains the soft fields
    (soft_fields)."""
    j = best.detach()
    if soft_eps and promote:
        j_near, near = _near_miss_index(ox, oy, oz, dx, dy, dz, spheres,
                                        hit, best, t_min, soft_eps)
        j = torch.where(near, j_near, j.long())
        hit = hit | near
    (cx, cy, cz, rsq, inv_r, alb_x, alb_y, alb_z, fuzz, ref_idx,
     mt_f) = take_cols(
        torch.stack([spheres.center_x, spheres.center_y, spheres.center_z,
                     spheres.radius_sq, spheres.inv_radius, spheres.albedo_x,
                     spheres.albedo_y, spheres.albedo_z, spheres.fuzz,
                     spheres.ref_idx, spheres.mat_type.to(torch.float32)]),
        j)

    gx, gy, gz = cx - ox, cy - oy, cz - oz
    nb_j = gx * dx + gy * dy + gz * dz
    c_j = gx * gx + gy * gy + gz * gz - rsq
    sq_j = safe_sqrt(nb_j * nb_j - c_j)
    t1_j = nb_j - sq_j
    t = torch.where(t1_j > t_min, t1_j, nb_j + sq_j)

    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    # normal = (p - center) * inv_radius (rayweek1.cpp:321); the signed
    # inv_radius flips it for hollow glass.
    nx, ny, nz = (px - cx) * inv_r, (py - cy) * inv_r, (pz - cz) * inv_r
    soft = {}
    if soft_eps:
        (nx, ny, nz), soft = soft_fields(ox, oy, oz, dx, dy, dz, rsq, nb_j,
                                         c_j, sq_j, nx, ny, nz, soft_eps)
    return (SoftHitRecord if soft_eps else HitRecord)(
        hit=hit, t=t, px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz,
        mat_type=mt_f.detach().to(torch.int32),
        albedo_x=alb_x, albedo_y=alb_y, albedo_z=alb_z,
        fuzz=fuzz, ref_idx=ref_idx, **soft)
