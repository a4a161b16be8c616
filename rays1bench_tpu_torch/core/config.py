"""Render configuration: the same fields, defaults and presets as
rays1bench_tpu/core/config.py (reference: src/common/common.h:3-31).

A frozen dataclass of Python scalars. Nothing here is jit-static any more;
the fields keep their JAX names so a config built for one package means the
same render in the other. `ray_chunk` bounds the plain renderer's wavefront
width. `early_exit=False` is the fixed-trip loop of the gradient path.
`pallas_intersect` keeps the JAX meaning: the plain renderer
(render/pipeline.render_image) then finds each bounce's winning row with the
closest-hit index kernel (kernels/intersect_index.py) instead of the plain
sweep; None is off there and on in the gradient path (grad/inverse._grad_cfg).
`soft_silhouette` > 0 is the soft-silhouette renderer of the geometry fits
(the field's comment below).
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
    # Soft-silhouette relaxation width (0 = off, the exact renderer), in
    # world units of the edge coordinate edge = |r| - b (b: distance from
    # the ray's line to the center; 0 at the silhouette, positive inside).
    # When > 0, a lane grazing a sphere (edge in (-9.2 * soft_silhouette, 0],
    # closest approach in front of its current hit) is promoted to a soft
    # hit of it, every hit gets cover = sigmoid(edge / soft_silhouette), and
    # the integrator runs the detached two-branch estimator: bounce off the
    # sphere with probability cover, else pass through it from the far exit,
    # with weights cover / sg(cover) and (1 - cover) / sg(1 - cover). The
    # weights are 1 at evaluation, so the render is the hard image in
    # expectation, but their derivative carries the two-sided silhouette
    # term: silhouette motion becomes differentiable, which the
    # fixed-topology gradient lacks. This is what fits sphere geometry
    # (centers, radii) to images. The JAX package's calibration: ~0.005 (1%
    # of a unit sphere's radius) gives 0.94-0.96 of the hard render's finite
    # difference silhouette derivative. A soft render is stochastic, so
    # grad/inverse.image_loss then takes the cross-seed U-statistic loss.
    # The respawn and wavefront engines are hard only and refuse it.
    soft_silhouette: float = 0.0

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


def get_config(name: str, **overrides) -> RenderConfig:
    """The preset `name`, with fields replaced by `overrides`."""
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg
