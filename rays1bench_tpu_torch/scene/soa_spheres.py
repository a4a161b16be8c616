"""SphereSOA: the sphere scene as a structure of arrays.

Written by hand as a frozen dataclass of tensors; the JAX package's
counterpart (rays1bench_tpu/scene/soa_spheres.py) is a pytree generated by
tools/soa_codegen.py. The builder has the reference container's mutation
surface (add/reserve/remove/copy, soa_sphere.h:22-63). Rows whose radius is
0.0 are placeholders (rayweek1.cpp:575-576).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rays1bench_tpu_torch.core.device import resolve

COLUMNS = ("center_x", "center_y", "center_z", "radius", "mat_type",
           "albedo_x", "albedo_y", "albedo_z", "fuzz", "ref_idx")

# Placeholder row values; every column but mat_type (int32) is float32.
_PAD = {name: 0.0 for name in COLUMNS}
_PAD["mat_type"] = 0
_PAD["ref_idx"] = 1.0


@dataclasses.dataclass(frozen=True)
class SphereSOA:
    """Every column is a length-N tensor on one device."""

    center_x: torch.Tensor
    center_y: torch.Tensor
    center_z: torch.Tensor
    radius: torch.Tensor
    mat_type: torch.Tensor
    albedo_x: torch.Tensor
    albedo_y: torch.Tensor
    albedo_z: torch.Tensor
    fuzz: torch.Tensor
    ref_idx: torch.Tensor

    @property
    def count(self) -> int:
        """Padded row count."""
        return self.center_x.shape[0]

    def astype(self, dtype) -> "SphereSOA":
        """Every float column cast to `dtype` (mat_type untouched)."""
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(dtype)
            for name in COLUMNS if name != "mat_type"})


class SphereSOABuilder:
    """Host-side builder: add(), remove() and copy_from() rows, then
    finalize() pads to a multiple of `pad_multiple` rows with placeholders
    and returns the SphereSOA."""

    def __init__(self):
        self.rows = {name: [] for name in COLUMNS}

    @property
    def count(self) -> int:
        return len(self.rows["center_x"])

    def reserve(self, n: int) -> None:
        """No-op capacity hint (the reference grows 1 + 2 * cap,
        soa_sphere.cpp:90; Python lists manage their own capacity)."""

    def add(self, center_x, center_y, center_z, radius, mat_type,
            albedo_x, albedo_y, albedo_z, fuzz, ref_idx) -> int:
        """Append one row; returns its index."""
        for name, v in zip(COLUMNS, (center_x, center_y, center_z, radius,
                                     mat_type, albedo_x, albedo_y, albedo_z,
                                     fuzz, ref_idx)):
            self.rows[name].append(v)
        return self.count - 1

    def remove(self, index: int) -> None:
        """Remove a row by moving the last row into its place (the
        reference's semantics, soa_sphere.cpp:108-121)."""
        for col in self.rows.values():
            col[index] = col[-1]
            col.pop()

    def copy_from(self, other: "SphereSOABuilder") -> None:
        """Replace every row with a copy of other's rows."""
        self.rows = {name: list(other.rows[name]) for name in COLUMNS}

    def finalize(self, pad_multiple: int = 128, device="cuda") -> SphereSOA:
        device = resolve(device)
        n = self.count
        pad = -n % pad_multiple
        cols = {}
        for name in COLUMNS:
            dtype = np.int32 if name == "mat_type" else np.float32
            # Python floats round to float32 through numpy, as in the JAX
            # builder, so both packages hold the same bits.
            arr = np.asarray(self.rows[name] + [_PAD[name]] * pad, dtype=dtype)
            cols[name] = torch.from_numpy(arr).to(device)
        return SphereSOA(**cols)
