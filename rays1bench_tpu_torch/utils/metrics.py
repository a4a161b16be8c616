"""Benchmark metrics (rays1bench_tpu/utils/metrics.py, copied: it imports
nothing of JAX, and the port keeps its own copy).

The reference's metric definition (SURVEY.md §5): one ray per radiance
evaluation including bounces (rayweek1.cpp:517), divided by wall-clock
seconds (common.h:41-44). Every throughput number of the port goes through
mrays_per_sec(), so the definition cannot drift.
"""

from __future__ import annotations

import dataclasses
from typing import List


def mrays_per_sec(num_rays: int, elapsed_seconds: float) -> float:
    """RESULT::get_mrays_per_sec (common.h:40-44)."""
    return num_rays / elapsed_seconds / 1e6 if elapsed_seconds else 0.0


def samples_per_sec(width: int, height: int, spp: int,
                    elapsed_seconds: float) -> float:
    return width * height * spp / elapsed_seconds if elapsed_seconds else 0.0


@dataclasses.dataclass
class ScalingPoint:
    """One point of a scaling sweep (1 device -> N devices)."""
    n_devices: int
    num_rays: int
    elapsed_seconds: float

    @property
    def mrays(self) -> float:
        return mrays_per_sec(self.num_rays, self.elapsed_seconds)


def scaling_efficiency(points: List[ScalingPoint]) -> List[float]:
    """Linear-scaling efficiency against the first point:
    eff_i = (mrays_i / mrays_0) / (n_i / n_0)."""
    if not points:
        return []
    base = points[0]
    return [(p.mrays / base.mrays) / (p.n_devices / base.n_devices)
            for p in points]
