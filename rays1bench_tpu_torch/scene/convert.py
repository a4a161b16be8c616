"""State carried across from the JAX package: its scene and camera leaves,
fetched as numpy arrays (`np.asarray(getattr(leaf_owner, name))`), become this
package's SphereSOA and Camera. The tests use it to feed both packages the
same scene and camera; numpy is the only thing the two share."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from rays1bench_tpu_torch.core.device import resolve
from rays1bench_tpu_torch.render.camera import Camera
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS, SphereSOA

CAMERA_FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v",
                 "lens_radius")


def _tensor(a, dtype, device):
    a = np.asarray(a)
    if a.dtype != dtype:
        raise ValueError(f"expected {np.dtype(dtype)}, got {a.dtype}")
    return torch.from_numpy(np.array(a)).to(resolve(device))


def soa_from_numpy(cols: Dict[str, np.ndarray], device="cuda") -> SphereSOA:
    """SphereSOA from a dict of the ten column arrays (mat_type int32, the
    rest float32), bits unchanged."""
    return SphereSOA(**{
        name: _tensor(cols[name], np.int32 if name == "mat_type"
                      else np.float32, device)
        for name in COLUMNS})


def camera_from_numpy(fields: Dict[str, np.ndarray], device="cuda") -> Camera:
    """Camera from a dict of float32 arrays: six length-3 vectors and the
    scalar lens_radius."""
    return Camera(**{name: _tensor(fields[name], np.float32, device)
                     for name in CAMERA_FIELDS})
