"""Thin-lens camera (rays1bench_tpu/render/camera.py; reference:
src/latest/rayweek1.cpp:364-394).

CameraSpec.build derives the basis on the host in Python doubles, exactly as
the JAX package does, and rounds it to float32 tensors once. generate_rays is
the planar per-ray raygen; its direction normalization takes IEEE 1/sqrt
(see core/vecmath.py), so it agrees with the JAX package within 2 ulp.

build_camera is the same derivation in float32 tensor ops, so that lookfrom
and vfov can be autograd leaves (grad/inverse.fit_camera). It is held
against the JAX package's build_camera, never against CameraSpec.build:
doubles and float32 round the basis differently in both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from rays1bench_tpu_torch.core import rng as rng_mod
from rays1bench_tpu_torch.core.device import resolve
from rays1bench_tpu_torch.core.vecmath import sqrt, vcross, vnorm, vsub


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """User-facing camera parameters (Camera::init args, rayweek1.cpp:366)."""
    lookfrom: Tuple[float, float, float]
    lookat: Tuple[float, float, float]
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov: float = 60.0          # vertical field of view, degrees
    aspect: float = 16.0 / 9.0
    aperture: float = 0.0
    focus_dist: float = 1.0

    def build(self, device="cuda") -> "Camera":
        """Derive the ray-gen basis (rayweek1.cpp:366-379)."""
        device = resolve(device)
        theta = self.vfov * math.pi / 180.0
        half_h = math.tan(theta / 2.0)
        half_w = self.aspect * half_h
        origin = self.lookfrom
        w = vnorm(vsub(self.lookfrom, self.lookat))
        u = vnorm(vcross(self.vup, w))
        v = vcross(w, u)
        fd = self.focus_dist
        lower_left = tuple(
            origin[i] - half_w * fd * u[i] - half_h * fd * v[i] - fd * w[i]
            for i in range(3))
        horizontal = tuple(2.0 * half_w * fd * u[i] for i in range(3))
        vertical = tuple(2.0 * half_h * fd * v[i] for i in range(3))
        f32 = lambda t: torch.tensor(t, dtype=torch.float32, device=device)
        return Camera(
            origin=f32(origin), lower_left=f32(lower_left),
            horizontal=f32(horizontal), vertical=f32(vertical),
            u=f32(u), v=f32(v), lens_radius=f32(self.aperture / 2.0))


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _unit(a):
    """a / |a|. The squared norm is summed as jnp.linalg.norm's jitted XLA
    sums it, x0*x0 then two fused multiply-adds, each emulated in float64
    (a float32 product is exact there) and rounded to float32; the root is
    correctly rounded (core/vecmath.sqrt)."""
    d = a.double()
    sq = (a[0] * a[0]).double()
    sq = (d[1] * d[1] + sq).float().double()
    sq = (d[2] * d[2] + sq).float()
    return a / sqrt(sq)


def build_camera(lookfrom, lookat, vup, vfov, aspect, aperture, focus_dist,
                 device=None) -> "Camera":
    """Differentiable Camera constructor (rays1bench_tpu/render/camera.py:
    58-78): CameraSpec.build's derivation (rayweek1.cpp:366-379) in float32
    tensor ops, so gradients flow from the Camera's tensors back to
    lookfrom, vfov or any other tensor argument. tan is taken in float64
    and rounded, as the roots are (core/vecmath.sqrt), so the CPU and the
    card agree; XLA's tan is within an ulp of it. lookfrom / lookat / vup
    are length-3 tensors or sequences, vfov is in degrees. The tensors land
    on `device`, by default lookfrom's (or the CPU for a sequence)."""
    if device is None and isinstance(lookfrom, torch.Tensor):
        device = lookfrom.device
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32, device=device)
    lookfrom, lookat, vup = f32(lookfrom), f32(lookat), f32(vup)
    theta = f32(vfov) * f32(math.pi / 180.0)
    half_h = torch.tan((theta * 0.5).double()).float()
    half_w = f32(aspect) * half_h
    w = _unit(lookfrom - lookat)
    u = _unit(_cross(vup, w))
    v = _cross(w, u)
    fd = f32(focus_dist)
    lower_left = lookfrom - half_w * fd * u - half_h * fd * v - fd * w
    return Camera(origin=lookfrom, lower_left=lower_left,
                  horizontal=2.0 * half_w * fd * u,
                  vertical=2.0 * half_h * fd * v, u=u, v=v,
                  lens_radius=f32(aperture / 2.0))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Derived camera: each vector a float32[3] tensor, lens_radius 0-dim."""
    origin: torch.Tensor
    lower_left: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    lens_radius: torch.Tensor

    def generate_rays(self, s, t, seed, ray_id):
        """Primary rays for film coordinates (s, t) in [0,1)^2
        (Camera::getRay, rayweek1.cpp:381-386): jitter the origin on the
        lens disk, aim at the film point, normalize the direction.
        Returns planar (ox, oy, oz, dx, dy, dz)."""
        rdx, rdy = rng_mod.in_unit_disk(seed, ray_id, -1, rng_mod.Slots.LENS_U)
        rdx = rdx * self.lens_radius
        rdy = rdy * self.lens_radius
        ox = self.origin[0] + self.u[0] * rdx + self.v[0] * rdy
        oy = self.origin[1] + self.u[1] * rdx + self.v[1] * rdy
        oz = self.origin[2] + self.u[2] * rdx + self.v[2] * rdy
        dx = self.lower_left[0] + s * self.horizontal[0] + t * self.vertical[0] - ox
        dy = self.lower_left[1] + s * self.horizontal[1] + t * self.vertical[1] - oy
        dz = self.lower_left[2] + s * self.horizontal[2] + t * self.vertical[2] - oz
        inv = 1.0 / sqrt(dx * dx + dy * dy + dz * dz)
        return ox, oy, oz, dx * inv, dy * inv, dz * inv
