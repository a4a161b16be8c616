"""The benchmark scenes: the same data as rays1bench_tpu/scene/builders.py
(reference: src/latest/rayweek1.cpp:552-719), column for column. The hollow
glass sphere of the small scene keeps its negative radius (rayweek1.cpp:572).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict

from rays1bench_tpu_torch.render.camera import CameraSpec
from rays1bench_tpu_torch.scene.crt_colors import CRT_COLOR_BYTES
from rays1bench_tpu_torch.scene.soa_spheres import SphereSOA, SphereSOABuilder
from rays1bench_tpu_torch.scene.spheres import DIELECTRIC, LAMBERTIAN, METAL


@dataclasses.dataclass(frozen=True)
class Scene:
    """A camera spec + the sphere SoA (rayweek1.cpp:539-549). n_real is the
    sphere count before placeholder padding."""
    name: str
    camera: CameraSpec
    spheres: SphereSOA
    n_real: int = 0


class _W:
    """The reference's add(center, radius, material) call shape
    (soa_sphere.h:22) on top of the builder."""

    def __init__(self):
        self.b = SphereSOABuilder()

    def lambertian(self, c, r, albedo):
        self.b.add(c[0], c[1], c[2], r, LAMBERTIAN, albedo[0], albedo[1], albedo[2], 0.0, 1.0)

    def metal(self, c, r, albedo, fuzz):
        fuzz = fuzz if fuzz < 1 else 1.0  # Metal clamps fuzz (rayweek1.cpp:422)
        self.b.add(c[0], c[1], c[2], r, METAL, albedo[0], albedo[1], albedo[2], fuzz, 1.0)

    def dielectric(self, c, r, ref_idx):
        self.b.add(c[0], c[1], c[2], r, DIELECTRIC, 1.0, 1.0, 1.0, 0.0, ref_idx)

    def scene(self, name, cam, pad_multiple, device) -> Scene:
        return Scene(name, cam, self.b.finalize(pad_multiple, device),
                     n_real=self.b.count)


def create_small_scene(aspect: float, pad_multiple: int = 128,
                       device="cuda") -> Scene:
    """5 spheres incl. hollow glass (rayweek1.cpp:552-579)."""
    cam = CameraSpec(lookfrom=(2, 1, 2), lookat=(0, 0, 0), vup=(0, 1, 0),
                     vfov=60.0, aspect=aspect, aperture=0.1, focus_dist=5.0)
    w = _W()
    w.lambertian((0, 0, -1), 0.5, (0.1, 0.2, 0.5))
    w.lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0))
    w.metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.3)
    w.dielectric((-1, 0, -1), 0.5, 1.5)
    w.dielectric((-1, 0, -1), -0.45, 1.5)   # hollow interior, normal flipped
    return w.scene("small", cam, pad_multiple, device)


def create_medium_scene(aspect: float, pad_multiple: int = 128,
                        device="cuda") -> Scene:
    """The 46-sphere aras_p Toy Path Tracer scene (rayweek1.cpp:582-651)."""
    cam = CameraSpec(lookfrom=(0, 2, 3), lookat=(0, 0, 0), vup=(0, 1, 0),
                     vfov=60.0, aspect=aspect, aperture=0.1 * 0.2, focus_dist=3.0)
    w = _W()
    w.lambertian((0, -100.5, -1), 100, (0.8, 0.8, 0.8))
    w.lambertian((2, 0, -1), 0.5, (0.8, 0.4, 0.4))
    w.lambertian((0, 0, -1), 0.5, (0.4, 0.8, 0.4))
    w.metal((-2, 0, -1), 0.5, (0.4, 0.4, 0.8), 0)
    w.metal((2, 0, 1), 0.5, (0.4, 0.8, 0.4), 0)
    w.metal((0, 0, 1), 0.5, (0.4, 0.8, 0.4), 0.2)
    w.metal((-2, 0, 1), 0.5, (0.4, 0.8, 0.4), 0.6)
    w.dielectric((0.5, 1, 0.5), 0.5, 1.5)
    w.lambertian((-1.5, 1.5, 0.0), 0.3, (0.8, 0.6, 0.2))
    for i, x in enumerate(range(4, -5, -1)):     # row z=-3: lambertian gray ramp
        g = 0.1 * (i + 1)
        w.lambertian((x, 0, -3), 0.5, (g, g, g))
    for i, x in enumerate(range(4, -5, -1)):     # row z=-4: metal gray ramp
        g = 0.1 * (i + 1)
        w.metal((x, 0, -4), 0.5, (g, g, g), 0)
    rainbow = [(0.8, 0.1, 0.1), (0.8, 0.5, 0.1), (0.8, 0.8, 0.1),
               (0.4, 0.8, 0.1), (0.1, 0.8, 0.1), (0.1, 0.8, 0.5),
               (0.1, 0.8, 0.8), (0.1, 0.1, 0.8), (0.5, 0.1, 0.8)]
    for i, x in enumerate(range(4, -5, -1)):     # row z=-5: metal rainbow
        w.metal((x, 0, -5), 0.5, rainbow[i], 0)
    # row z=-6: lambertian rainbow, except the last is metal (rayweek1.cpp:645)
    for i, x in enumerate(range(4, -5, -1)):
        if i < 8:
            w.lambertian((x, 0, -6), 0.5, rainbow[i])
        else:
            w.metal((x, 0, -6), 0.5, rainbow[i], 0)
    w.lambertian((1.5, 1.5, -2), 0.3, (0.1, 0.2, 0.5))
    return w.scene("medium", cam, pad_multiple, device)


def _grid_scene(name, aspect, grid_w, grid_h, color, ref_idx, pad_multiple,
                device) -> Scene:
    """Sphere grid + ground + 3 big spheres, the large scene's layout:
    i%20==0 -> Dielectric(ref_idx(i)), i%10==0 -> Metal raised +0.1y, else
    Lambertian; color(i) -> (r, g, b) in [0, 1]."""
    cam = CameraSpec(lookfrom=(3, 8, 15), lookat=(0, 0, 0), vup=(0, 1, 0),
                     vfov=60.0, aspect=aspect, aperture=0.1, focus_dist=10.0)
    w = _W()
    for y in range(grid_h):
        for x in range(grid_w):
            i = x + y * grid_w
            px, py, pz = (x - grid_w // 2) * 1.1, 0.0, (y - grid_h // 2) * 1.1
            r, g, b = color(i)
            if i % 20 == 0:
                w.dielectric((px, py, pz), 0.45, ref_idx(i))
            elif i % 10 == 0:
                w.metal((px, py + 0.1, pz), 0.45, (r, g, b),
                        0.01 + 0.5 * y / float(grid_h))
            else:
                w.lambertian((px, py, pz), 0.45, (r, g, b))
    w.lambertian((0, -1000.5, 0), 1000, (0.5, 0.5, 0.5))
    w.metal((5, 3, 0), 2, (0.5, 0.5, 0.8), 0.65)
    w.dielectric((0, 3, 0), 2, 1.5)
    w.metal((-5, 3, 0), 2, (0.8, 0.2, 0.2), 0.05)
    return w.scene(name, cam, pad_multiple, device)


def create_large_scene(aspect: float, pad_multiple: int = 128,
                       device="cuda") -> Scene:
    """30x16 grid + ground + 3 big spheres = 484 (rayweek1.cpp:654-719);
    grid colors from the captured CRT rand() bytes (crt_colors.py)."""
    color = lambda i: tuple(CRT_COLOR_BYTES[i * 3 + k] / 255.0 for k in range(3))
    return _grid_scene("large", aspect, 30, 16, color,
                       lambda i: 1.2 + i * 0.05, pad_multiple, device)


def create_giant_scene(aspect: float, pad_multiple: int = 128,
                       device="cuda") -> Scene:
    """66x62 grid + ground + 3 big spheres = 4096 rows, a stress scene with
    no reference analog; grid colors from a fixed-seed PRNG, dielectric
    indices wrapped to 1.2..2.4."""
    rng = random.Random(111)
    color = lambda i: tuple(rng.randrange(256) / 255.0 for _ in range(3))
    return _grid_scene("giant", aspect, 66, 62, color,
                       lambda i: 1.2 + (i % 24) * 0.05, pad_multiple, device)


SCENES: Dict[str, Callable[..., Scene]] = {
    "small": create_small_scene,
    "medium": create_medium_scene,
    "large": create_large_scene,
    "giant": create_giant_scene,
}
