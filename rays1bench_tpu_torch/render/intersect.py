"""Closest-hit ray/sphere intersection, plain version
(rays1bench_tpu/render/intersect.py, hard mode; reference:
src/latest/rayweek1.cpp:152-339).

The reference's two-pass compaction becomes a dense masked sweep over the
(rays x spheres) candidate matrix and a first-minimum argmin; the hit record
is then recomputed from the winning row by hit_record_from_index, which the
gradient path's topology replay calls directly. Normalized ray directions
are assumed. Not ported yet: the soft silhouette mode (_near_miss_index and
the soft fields of the record).

take_cols is a plain clamped index on this port. The JAX package runs it as
a dense select sweep with a one-hot custom VJP, because TPU gathers and
scatters serialize per element (rays1bench_tpu/render/intersect.py:41-94);
on a GPU an index is cheap and autograd's index backward is the scatter-add.
"""

from __future__ import annotations

import dataclasses

import torch

from rays1bench_tpu_torch.core.vecmath import safe_sqrt, sqrt
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
                t_min: float, t_max: float) -> HitRecord:
    """Closest intersection of N rays against all S spheres: the index sweep,
    then an O(N) recompute of t, point and normal from the winning row."""
    best, hit = closest_hit_index(ox, oy, oz, dx, dy, dz, spheres,
                                  t_min, t_max)
    return hit_record_from_index(ox, oy, oz, dx, dy, dz, spheres, best, hit,
                                 t_min)


def hit_record_from_index(ox, oy, oz, dx, dy, dz, spheres: PreparedSpheres,
                          best, hit, t_min: float) -> HitRecord:
    """Differentiable hit record of the given winning rows (hard mode).

    best: int[N] row per ray (-1 reads row 0, masked by hit); hit: bool[N].
    Gradients flow through t, point, normal and the material columns at the
    fixed index; mat_type rides the float stack and leaves it detached."""
    (cx, cy, cz, rsq, inv_r, alb_x, alb_y, alb_z, fuzz, ref_idx,
     mt_f) = take_cols(
        torch.stack([spheres.center_x, spheres.center_y, spheres.center_z,
                     spheres.radius_sq, spheres.inv_radius, spheres.albedo_x,
                     spheres.albedo_y, spheres.albedo_z, spheres.fuzz,
                     spheres.ref_idx, spheres.mat_type.to(torch.float32)]),
        best)

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
    return HitRecord(
        hit=hit, t=t, px=px, py=py, pz=pz,
        nx=(px - cx) * inv_r, ny=(py - cy) * inv_r, nz=(pz - cz) * inv_r,
        mat_type=mt_f.detach().to(torch.int32),
        albedo_x=alb_x, albedo_y=alb_y, albedo_z=alb_z,
        fuzz=fuzz, ref_idx=ref_idx)
