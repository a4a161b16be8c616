"""Gradient-free closest-hit index per ray: the port of
rays1bench_tpu/kernels/intersect_pallas.py.

The differentiable pipeline (render/pipeline.render_image with
cfg.pallas_intersect, the engine="pipeline" gradient) needs gradients
through the hit record but not through the choice of the winning sphere.
That splits in two: this O(N*S) sweep gives each ray its winning row and a
hit flag, and render/intersect.hit_record_from_index rebuilds t, point and
normal from that row in O(N), differentiably.

`closest_hit_index` launches the CUDA kernel of csrc/intersect_index.cu on
a CUDA tensor and runs `closest_hit_index_reference`, its plain torch
version, on a CPU tensor; there is no fallback between the two. The kernel
reads the prepared columns and builds the table itself, so on the card the
call launches nothing before it; `pack` builds the same table for the plain
version. Both keep the Pallas kernel's exact form (`_kernel`, `_pack`): a
(4, S) table with
radius_sq = -1e30 on placeholder rows; `disc > 0 ? sqrt(max(disc, 0)) :
INF`; t = t1 > t_min ? t1 : t2; a root counts only above t_min; the first
row wins among equal roots; hit = best root < 3e38; no t_max test. It picks
the same winner as the port's two other sweeps (megakernel.sweep, whose
misses go through NaN, and render/intersect.closest_hit_index, with its
valid mask and t_max); tests/test_torch_intersect_index.py holds all three
to it.

No autograd.Function: the outputs are an integer index and a bool, which
carry no gradient in torch, and the inputs are detached before the call.
That is what the JAX custom_vjp declares with its zero cotangents
(intersect_pallas.py:119-132). Dropped TPU workaround: N is not padded to a
2048-ray tile.
"""

from __future__ import annotations

import ctypes

import torch

from rays1bench_tpu_torch.core.vecmath import sqrt
from rays1bench_tpu_torch.kernels import build
from rays1bench_tpu_torch.kernels.megakernel import check_rays, check_tensor
from rays1bench_tpu_torch.scene.spheres import PreparedSpheres

_BIG = 3.0e38
# The PreparedSpheres columns the kernel builds its table from.
_COLUMNS = ("center_x", "center_y", "center_z", "radius_sq", "valid")

# Kernel launches made by closest_hit_index (one per call on a CUDA tensor).
LAUNCHES = 0


def pack(prep: PreparedSpheres) -> torch.Tensor:
    """The (4, S) float32 table of intersect_pallas._pack: center x/y/z and
    radius_sq, -1e30 on placeholder rows, detached."""
    with torch.no_grad():
        rsq = torch.where(prep.valid > 0.0, prep.radius_sq, -1e30)
        return torch.stack([prep.center_x, prep.center_y, prep.center_z,
                            rsq]).contiguous()


def closest_hit_index_reference(table: torch.Tensor, ox, oy, oz, dx, dy, dz,
                                t_min: float):
    """Plain version of the index kernel, on any device, all rows at once:
    (idx int32[N], hit bool[N]) for the (4, S) table of `pack`."""
    cox = table[0] - ox[:, None]
    coy = table[1] - oy[:, None]
    coz = table[2] - oz[:, None]
    nb = cox * dx[:, None] + coy * dy[:, None] + coz * dz[:, None]
    c = cox * cox + coy * coy + coz * coz - table[3]
    disc = nb * nb - c
    sq = torch.where(disc > 0.0, sqrt(torch.clamp_min(disc, 0.0)),
                     float("inf"))
    t1 = nb - sq
    t2 = nb + sq
    t = torch.where(t1 > t_min, t1, t2)
    tm = torch.where(t > t_min, t, float("inf"))
    bt, idx = torch.min(tm, dim=1)  # first minimum wins
    return idx.to(torch.int32), bt < _BIG


def _index_kernel():
    lib = build.load("intersect_index", "intersect_index.cu")
    fn = lib.rays1_index_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, i, p, p, p, p, p, p, i, f, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def closest_hit_index(prep: PreparedSpheres, ox, oy, oz, dx, dy, dz,
                      t_min: float):
    """Winning row and hit flag of N rays against the prepared spheres.

    ox..dz: float32[N] ray planes on the spheres' device (detached here:
    the index is constant under differentiation). Returns (idx int32[N],
    the first row with the smallest root above t_min, 0 on a miss; hit
    bool[N]). CUDA tensors launch the kernel of csrc/intersect_index.cu on
    the current stream; CPU tensors run closest_hit_index_reference."""
    global LAUNCHES
    device = prep.center_x.device
    s_count = prep.count
    cols = [getattr(prep, c).detach().contiguous() for c in _COLUMNS]
    for name, col in zip(_COLUMNS, cols):
        check_tensor(name, col, torch.float32, (s_count,), device)
    rays = [r.detach().contiguous() for r in (ox, oy, oz, dx, dy, dz)]
    n = rays[0].shape[0] if rays[0].dim() == 1 else -1
    check_rays(n, device, **dict(zip(("ox", "oy", "oz", "dx", "dy", "dz"),
                                     rays)))
    if device.type == "cpu":
        return closest_hit_index_reference(pack(prep), *rays, t_min)
    if device.type != "cuda":
        raise ValueError(f"closest_hit_index runs on cuda or cpu, not {device}")
    idx = torch.empty(n, dtype=torch.int32, device=device)
    hit = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return idx, hit
    err = _index_kernel()(*(c.data_ptr() for c in cols), s_count,
                          *(r.data_ptr() for r in rays), n, t_min,
                          idx.data_ptr(), hit.data_ptr(),
                          torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"index kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return idx, hit
