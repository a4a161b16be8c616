"""Render configuration: the same fields, defaults and presets as
rays1bench_tpu/core/config.py (reference: src/common/common.h:3-31).

A frozen dataclass of Python scalars. Nothing here is jit-static any more;
the fields keep their JAX names so a config built for one package means the
same render in the other. `ray_chunk` bounds the plain renderer's wavefront
width. `early_exit=False` is the fixed-trip loop of the gradient path.
`pallas_intersect` and `soft_silhouette` are carried for field parity with
the JAX config, but the port has only the plain sweep and the hard
renderer, so a value that asks for another mode raises instead of being
ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render parameters (reference macros, common.h:3-31)."""

    width: int = 1280              # SCREEN_W (common.h:20)
    height: int = 720              # SCREEN_H (common.h:21)
    spp: int = 10                  # NUM_SAMPLES_PER_PIXEL (common.h:24-28)
    # Scatter is allowed while depth < max_bounces, so a path traces at most
    # max_bounces+1 segments (common.h:19).
    max_bounces: int = 50
    t_min: float = 1e-3            # world->hit(r, 0.001f, FLT_MAX) (rayweek1.cpp:519)
    t_max: float = 3.4e38          # FLT_MAX
    ray_chunk: int = 131072
    seed: int = 10001
    early_exit: bool = True
    pallas_intersect: Optional[bool] = None
    soft_silhouette: float = 0.0

    def __post_init__(self):
        if self.pallas_intersect:
            raise ValueError("pallas_intersect=True (the closest-hit index "
                             "kernel) is not ported; the port uses the plain "
                             "sweep")
        if self.soft_silhouette != 0.0:
            raise ValueError("soft_silhouette > 0 (the soft renderer) is not "
                             "ported; the port renders hard silhouettes")

    @property
    def aspect(self) -> float:
        """Camera aspect ratio, SCREEN_W / SCREEN_H (rayweek1.cpp:566)."""
        return float(self.width) / float(self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def num_primary_rays(self) -> int:
        return self.num_pixels * self.spp

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


PRESETS = {
    "full": RenderConfig(),
    "full_mt": RenderConfig(spp=250),
    "quick": RenderConfig(width=80, height=60, spp=4),
    "quick_mt": RenderConfig(width=80, height=60, spp=100),
    "baseline_small": RenderConfig(width=200, height=100, spp=4, max_bounces=10),
    "baseline_medium": RenderConfig(width=400, height=200, spp=16, max_bounces=10),
    "baseline_large": RenderConfig(width=1280, height=720, spp=16, max_bounces=10),
    "baseline_large_4spp": RenderConfig(width=1280, height=720, spp=4, max_bounces=10),
}

