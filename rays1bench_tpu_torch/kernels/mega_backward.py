"""Fused backward of the fixed-topology replay: the CUDA kernel's wrapper and
its plain version (rays1bench_tpu/kernels/mega_backward.py).

The gradient of the megakernel-forward path (grad/mega.py) is the exact
derivative of the replay render at the recorded hit topology: every bounce's
hit record is rebuilt from the recorded row of the exact sphere table, then
scattered, attenuated and, on a miss, lit by the sky. `backward` returns the
cotangents of the ten GRAD_ROWS sphere columns, summed per row, and of the
six primary-ray planes, for the caller to chain onto the scene leaves and the
camera. On a CUDA tensor it launches csrc/mega_backward.cu, whose adjoint is
derived by hand (csrc/path_adjoint.cuh); on a CPU tensor it runs
`backward_reference`, torch.autograd over a replay written with
`bounce_core`. There is no fallback between the two.

With cfg.soft_silhouette the replayed bounce is the detached two-branch
soft-silhouette estimator at the recorded, already promoted rows
(mega_backward._bounce_core's soft branch): cover and the far exit are
rebuilt from the row's columns, the branch draw is recomputed from the
SILHOUETTE_P slot, and the branch weights carry the silhouette term.

Dropped TPU workarounds: the S-select sweep of `lookup` (a GPU loads the
winning row by index), the slot order and its tiles, and the VMEM limits
MAX_UNROLLED, MAX_SPHERES and _VMEM_BUDGET with the blocked accumulator
scheme they chose between. `supported` states the port's own limits: the
shared memory of one block and the kernel's compile-time bounce cap.
"""

from __future__ import annotations

import ctypes

import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.core.vecmath import f32, safe_sqrt
from rays1bench_tpu_torch.kernels import build
from rays1bench_tpu_torch.kernels.megakernel import check_rays, check_tensor
from rays1bench_tpu_torch.render.integrator import sky_color, two_branch
from rays1bench_tpu_torch.render.intersect import (HitRecord, SoftHitRecord,
                                                   soft_fields, take_cols)
from rays1bench_tpu_torch.render.materials import scatter
from rays1bench_tpu_torch.scene.spheres import PreparedSpheres

# Rows of the gradient output matrix, in PreparedSpheres column order.
GRAD_ROWS = ("center_x", "center_y", "center_z", "radius_sq", "inv_radius",
             "albedo_x", "albedo_y", "albedo_z", "fuzz", "ref_idx")
NUM_GRAD = len(GRAD_ROWS)
# The exact table: the ten gradient columns and mat_type as a float.
NUM_COLS = NUM_GRAD + 1
# The kernel checkpoints each live bounce in a per-thread array of at most
# this many + 1 entries (kMaxBounces in csrc/mega_backward.cu; a launch of
# up to 10 bounces takes the 11-entry instantiation).
MAX_BOUNCES = 50
# Dynamic shared memory a block may use on Hopper (227 KB), less a margin
# for static shared memory: the (11, S) table and the (10, S) accumulator.
_MAX_SMEM_BYTES = 232448 - 1024

# Kernel launches made by backward (one per call on a CUDA tensor).
LAUNCHES = 0


def pack_exact(prep: PreparedSpheres) -> torch.Tensor:
    """(11, S) float32 exact sphere table: the GRAD_ROWS columns, then
    mat_type as a float (exact for codes 0..2). No 8-bit albedo: this is the
    gradient path."""
    return torch.stack([
        prep.center_x, prep.center_y, prep.center_z, prep.radius_sq,
        prep.inv_radius, prep.albedo_x, prep.albedo_y, prep.albedo_z,
        prep.fuzz, prep.ref_idx, prep.mat_type.to(torch.float32),
    ])


def supported(s_count: int, cfg: RenderConfig) -> bool:
    """Can backward's kernel take this table and config? The exact table
    and the accumulator share one block's shared memory (84 B per row, up
    to 2,755 rows), and cfg.max_bounces must be within MAX_BOUNCES."""
    return (4 * (NUM_COLS + NUM_GRAD) * s_count <= _MAX_SMEM_BYTES
            and cfg.max_bounces <= MAX_BOUNCES)


def bounce_core(o, d, a, cols, mt, hit, alive, cont, b, ray_id, seed,
                t_min, max_bounces, soft_eps: float = 0.0):
    """One differentiable replay bounce on per-lane values
    (mega_backward._bounce_core): the hit record of the given columns, the
    scatter, the sky on a miss, and the state update. cols: the ten
    GRAD_ROWS columns of each lane's row; cont=None computes the continue
    mask, else the given one is used. soft_eps > 0: the soft fields of the
    record (render/intersect.hit_record_from_index's formulas, no
    promotion) and the two-branch draw (render/integrator.two_branch).

    Returns (o', d', a', radiance added, cont)."""
    ox, oy, oz = o
    dx, dy, dz = d
    ar, ag, ab = a
    cx, cy, cz, rsq, ivr, alx, aly, alz, fz, ri = cols

    gx, gy, gz = cx - ox, cy - oy, cz - oz
    nb = gx * dx + gy * dy + gz * dz
    c = gx * gx + gy * gy + gz * gz - rsq
    sq = safe_sqrt(nb * nb - c)
    t1 = nb - sq
    t = torch.where(t1 > t_min, t1, nb + sq)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    nx = (px - cx) * ivr
    ny = (py - cy) * ivr
    nz = (pz - cz) * ivr
    soft = {}
    if soft_eps:
        (nx, ny, nz), soft = soft_fields(ox, oy, oz, dx, dy, dz, rsq, nb, c,
                                         sq, nx, ny, nz, soft_eps)
    rec = (SoftHitRecord if soft_eps else HitRecord)(
        hit=hit, t=t, px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz, mat_type=mt,
        albedo_x=alx, albedo_y=aly, albedo_z=alz, fuzz=fz, ref_idx=ri, **soft)

    (sx, sy, sz), (mr, mg, mb), ok = scatter(dx, dy, dz, rec, seed, ray_id, b)
    if soft_eps:
        (px, py, pz), (sx, sy, sz), (mr, mg, mb), ok, _ = two_branch(
            rec, sx, sy, sz, mr, mg, mb, ok, dx, dy, dz, seed, ray_id, b)
    skr, skg, skb = sky_color(dx, dy, dz)
    miss = alive & ~hit
    radd = (torch.where(miss, ar * skr, 0.0),
            torch.where(miss, ag * skg, 0.0),
            torch.where(miss, ab * skb, 0.0))

    if cont is None:
        cont = alive & hit & ok & (b < max_bounces)
    o2 = (torch.where(cont, px, ox), torch.where(cont, py, oy),
          torch.where(cont, pz, oz))
    d2 = (torch.where(cont, sx, dx), torch.where(cont, sy, dy),
          torch.where(cont, sz, dz))
    a2 = (torch.where(cont, ar * mr, ar), torch.where(cont, ag * mg, ag),
          torch.where(cont, ab * mb, ab))
    return o2, d2, a2, radd, cont


def replay(table: torch.Tensor, o, d, ray_id, topo, cfg: RenderConfig):
    """Per-ray radiance of the fixed-topology replay through bounce_core:
    (rr, rg, rb) float32[N], differentiable in the exact table and the rays.
    Lanes with ray_id >= cfg.num_primary_rays are padding."""
    alive = ray_id < cfg.num_primary_rays
    one = torch.ones_like(o[0])
    a = (one, one, one)
    rad = [torch.zeros_like(o[0]) for _ in range(3)]
    for b in range(cfg.max_bounces + 1):
        if not bool(alive.any()):
            break
        j = topo[b]
        cols = take_cols(table, j)
        mt = cols[NUM_GRAD].detach().to(torch.int32)
        o, d, a, radd, alive = bounce_core(
            o, d, a, tuple(cols[:NUM_GRAD]), mt, j >= 0, alive, None, b,
            ray_id, cfg.seed, cfg.t_min, cfg.max_bounces,
            cfg.soft_silhouette)
        rad = [r + x for r, x in zip(rad, radd)]
    return tuple(rad)


def backward_reference(prep: PreparedSpheres, ox, oy, oz, dx, dy, dz, ray_id,
                       ct_r, ct_g, ct_b, topo, cfg: RenderConfig):
    """Plain version of the fused backward, on any device: torch.autograd
    over `replay`, pulling (ct_r, ct_g, ct_b) back onto the exact table and
    the rays. Returns (grads float32[10, S] in GRAD_ROWS order, (ct_ox,
    ct_oy, ct_oz, ct_dx, ct_dy, ct_dz) float32[N]). Where no ray hits at
    its first bounce, the origins reach no radiance: their cotangents are
    0, as jax.vjp gives them."""
    with torch.enable_grad():
        table = pack_exact(prep).detach().requires_grad_(True)
        rays = [r.detach().requires_grad_(True)
                for r in (ox, oy, oz, dx, dy, dz)]
        rad = replay(table, tuple(rays[:3]), tuple(rays[3:]), ray_id, topo,
                     cfg)
        grads = torch.autograd.grad(rad, [table] + rays,
                                    grad_outputs=(ct_r, ct_g, ct_b),
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, [table] + rays)]
    return grads[0][:NUM_GRAD], tuple(grads[1:])


def _backward_kernel():
    lib = build.load("mega_backward", "mega_backward.cu")
    fn = lib.rays1_backward_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, f,
                   ctypes.c_uint32, f, f, p, p, p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def backward(prep: PreparedSpheres, ox, oy, oz, dx, dy, dz, ray_id, ct_r,
             ct_g, ct_b, topo, cfg: RenderConfig):
    """Gradient of the fixed-topology replay for N primary rays.

    ox..dz: float32[N] primary rays; ray_id: int32[N] global ids in any
    order (ids >= cfg.num_primary_rays are padding); ct_r/g/b: float32[N]
    cotangents of each ray's linear radiance; topo: int32[max_bounces+1, N]
    winning raw row per bounce (-1 otherwise), as trace_topology returns it.

    Returns (grads float32[10, S] per-row cotangents of the GRAD_ROWS
    columns, (ct_ox, ct_oy, ct_oz, ct_dx, ct_dy, ct_dz) float32[N]). CUDA
    tensors launch csrc/mega_backward.cu on the current stream (its column
    sums are float atomics, so their order changes from run to run); CPU
    tensors run backward_reference. cfg.soft_silhouette > 0 differentiates
    the soft replay; topo then holds the soft forward's promoted rows."""
    global LAUNCHES
    device = ox.device
    n = ox.shape[0] if ox.dim() == 1 else -1
    check_rays(n, device, ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz,
               ray_id=ray_id, ct_r=ct_r, ct_g=ct_g, ct_b=ct_b)
    check_tensor("topo", topo, torch.int32, (cfg.max_bounces + 1, n), device)
    if device.type == "cpu":
        return backward_reference(prep, ox, oy, oz, dx, dy, dz, ray_id, ct_r,
                                  ct_g, ct_b, topo, cfg)
    if device.type != "cuda":
        raise ValueError(f"backward runs on cuda or cpu, not {device}")
    table = pack_exact(prep).contiguous()
    s_count = table.shape[1]
    check_tensor("table", table, torch.float32, (NUM_COLS, s_count), device)
    if not supported(s_count, cfg):
        raise ValueError(
            f"the fused backward takes at most {MAX_BOUNCES} bounces and "
            f"{_MAX_SMEM_BYTES // (4 * (NUM_COLS + NUM_GRAD))} sphere rows "
            f"(one block's shared memory); got {cfg.max_bounces} and "
            f"{s_count}")

    grads = torch.zeros((NUM_GRAD, s_count), dtype=torch.float32,
                        device=device)
    work = torch.zeros(1, dtype=torch.int32, device=device)  # chunk counter
    cts = tuple(torch.empty(n, dtype=torch.float32, device=device)
                for _ in range(6))
    if n == 0:
        return grads, cts
    soft = cfg.soft_silhouette
    fn = _backward_kernel()
    err = fn(table.data_ptr(), s_count, ox.data_ptr(), oy.data_ptr(),
             oz.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(),
             ray_id.data_ptr(), ct_r.data_ptr(), ct_g.data_ptr(),
             ct_b.data_ptr(), topo.data_ptr(), n, cfg.num_primary_rays,
             cfg.max_bounces, cfg.t_min, cfg.seed, soft,
             f32(1.0 / soft) if soft else 0.0, grads.data_ptr(),
             *(c.data_ptr() for c in cts), work.data_ptr(),
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mega_backward kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return grads, cts
