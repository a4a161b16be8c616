"""Derived hot-loop view of the sphere SoA (rays1bench_tpu/scene/spheres.py):
radius_sq, signed inv_radius and the validity mask, as the reference
precomputes them (reference: src/latest/soa_sphere.cpp:80-82)."""

from __future__ import annotations

import dataclasses

import torch

from rays1bench_tpu_torch.scene.soa_spheres import SphereSOA

# Material codes (replace virtual Material* dispatch, rayweek1.cpp:131-136).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2


@dataclasses.dataclass(frozen=True)
class PreparedSpheres:
    """Original columns + derived ones + validity mask."""

    center_x: torch.Tensor
    center_y: torch.Tensor
    center_z: torch.Tensor
    radius_sq: torch.Tensor     # radius^2 (same for signed radii)
    inv_radius: torch.Tensor    # 1/radius, signed: flips normals for hollow glass
    valid: torch.Tensor         # float32 1.0 for real spheres, 0.0 for placeholders
    mat_type: torch.Tensor
    albedo_x: torch.Tensor
    albedo_y: torch.Tensor
    albedo_z: torch.Tensor
    fuzz: torch.Tensor
    ref_idx: torch.Tensor

    @property
    def count(self) -> int:
        return self.center_x.shape[0]


def prepare(s: SphereSOA) -> PreparedSpheres:
    """Build the derived view. Placeholder rows (radius == 0,
    rayweek1.cpp:575-576) get inv_radius = 0 and valid = 0. A negative radius
    (hollow glass) keeps its sign in inv_radius, which turns its normals
    inward."""
    is_real = s.radius != 0.0
    safe_r = torch.where(is_real, s.radius, 1.0)
    return PreparedSpheres(
        center_x=s.center_x,
        center_y=s.center_y,
        center_z=s.center_z,
        radius_sq=s.radius * s.radius,
        inv_radius=torch.where(is_real, 1.0 / safe_r, 0.0),
        valid=is_real.to(torch.float32),
        mat_type=s.mat_type,
        albedo_x=s.albedo_x,
        albedo_y=s.albedo_y,
        albedo_z=s.albedo_z,
        fuzz=s.fuzz,
        ref_idx=s.ref_idx,
    )
