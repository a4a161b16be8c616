"""Morton row order for the sort-trim (rays1bench_tpu/kernels/culling.py).

Spheres are sorted by the 30-bit Morton code of their centers, placeholder
rows last, so the pipeline can trim padding down to a power of two
(kernels/pipeline.prepare_trimmed). The permutation must equal the JAX
package's: the sweep keeps the FIRST of equal hits, so row order sets the
tie order. Same codes, same stable sort.
"""

from __future__ import annotations

import torch

_PLACEHOLDER_CODE = 0xFFFFFFFF


def _expand_bits(v):
    """Spread 10 bits to every 3rd bit (for 30-bit 3D Morton codes)."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_order(cx, cy, cz, valid):
    """int64 permutation sorting real spheres by 3D Morton code, placeholders
    last; a stable sort, so ties keep row order."""
    codes = torch.zeros(cx.shape, dtype=torch.int64, device=cx.device)
    for shift, c in zip((2, 1, 0), (cx, cy, cz)):
        lo = torch.where(valid, c, 3e38).min()
        hi = torch.where(valid, c, -3e38).max()
        span = torch.clamp_min(hi - lo, 1e-9)
        q = torch.clamp((c - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int32)
        codes = codes | (_expand_bits(q) << shift)
    codes = torch.where(valid, codes, _PLACEHOLDER_CODE)
    return torch.sort(codes, stable=True).indices
