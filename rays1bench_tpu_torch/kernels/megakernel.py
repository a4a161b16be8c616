"""The port's path-tracing kernels and their plain versions
(rays1bench_tpu/kernels/megakernel.py).

`trace_respawn` is the counterpart of `trace_pallas_respawn`: every sample
of every pixel traced to completion, returning per-pixel radiance sums and
per-pixel ray counts in image order. `trace_topology` is the counterpart of
`trace_pallas(emit_topology=True)`, the gradient path's forward: one thread
per given primary ray, per-ray radiance and counts, and the winning sphere
row of every bounce. On a CUDA tensor each launches its kernel
(csrc/respawn.cu, csrc/oneshot.cu, built by kernels/build.py); on a CPU
tensor it runs its plain torch version (`trace_respawn_reference`,
`trace_topology_reference`). There is no fallback between the two: a CUDA
input launches the kernel or raises.

All read the same packed tables as the Pallas kernels, kept bit for bit:
the (7, S) sphere table of `pack_spheres` (placeholder radius_sq poisoned to
-1e30, 8-bit albedo as r*65536 + g*256 + b, material and parameter as
mt*32 + param) and the 19-float camera row of `pack_camera`. `ref_idx` and
`fuzz` therefore decode to the same floats as in the JAX kernel, which is
what makes ray counts comparable. Dropped TPU workarounds: the pixel-tile
slot permutation (the kernels read and write in ray or image order),
`tile_rays`, `unroll`, `sync_every` and `debug_iters`. Without
`sync_every` there is no overshoot past max_bounces, so the topology write
guard of the Pallas kernel has nothing to guard.
"""

from __future__ import annotations

import ctypes

import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.core.vecmath import sqrt
from rays1bench_tpu_torch.kernels import build
from rays1bench_tpu_torch.render.camera import Camera
from rays1bench_tpu_torch.render.integrator import trace
from rays1bench_tpu_torch.render.intersect import HitRecord
from rays1bench_tpu_torch.render.pipeline import primary_rays
from rays1bench_tpu_torch.scene.spheres import PreparedSpheres

NUM_SPHERE_ROWS = 7
CAMERA_FLOATS = 19
_BIG = 3.0e38
# Dynamic shared memory a block may use on Hopper (227 KB), less the
# kernel's static shared arrays.
_MAX_TABLE_BYTES = 232448 - 1024

# Kernel launches made by trace_respawn and by trace_topology (one per
# call on a CUDA tensor).
LAUNCHES = 0
ONESHOT_LAUNCHES = 0


def pack_spheres(prep: PreparedSpheres) -> torch.Tensor:
    """The (7, S) float32 sphere table of megakernel._pack_spheres: center
    x/y/z, radius_sq (-1e30 on placeholder rows, so their discriminant is
    negative for every ray), signed inv_radius, albedo packed as
    r*65536 + g*256 + b on a 0..255 scale, and mat_type*32 + param where
    param is ref_idx for dielectrics and fuzz otherwise (param < 32)."""
    q = lambda v: torch.round(torch.clamp(v, 0.0, 1.0) * 255.0)
    alb = q(prep.albedo_x) * 65536.0 + q(prep.albedo_y) * 256.0 + q(prep.albedo_z)
    param = torch.where(prep.mat_type == 2, prep.ref_idx, prep.fuzz)
    return torch.stack([
        prep.center_x,
        prep.center_y,
        prep.center_z,
        torch.where(prep.valid > 0.0, prep.radius_sq, -1e30),
        prep.inv_radius,
        alb,
        prep.mat_type.to(torch.float32) * 32.0 + param,
    ]).contiguous()


def pack_camera(camera: Camera) -> torch.Tensor:
    """The camera as 19 float32: origin, lower_left, horizontal, vertical,
    u, v (3 each) and lens_radius (megakernel._pack_camera, flattened)."""
    return torch.cat([camera.origin, camera.lower_left, camera.horizontal,
                      camera.vertical, camera.u, camera.v,
                      camera.lens_radius.reshape(1)]).contiguous()


def unpack_camera(cam: torch.Tensor) -> Camera:
    return Camera(origin=cam[0:3], lower_left=cam[3:6], horizontal=cam[6:9],
                  vertical=cam[9:12], u=cam[12:15], v=cam[15:18],
                  lens_radius=cam[18])


def sweep(packed: torch.Tensor, ox, oy, oz, dx, dy, dz, t_min: float):
    """Dense closest-hit sweep over the packed table (megakernel.
    _make_intersect, hard mode), all rows at once: (best int64[N], bt
    float32[N]), the first row with the smallest root above t_min and that
    root, +inf where nothing qualifies. Misses need no mask: a negative
    discriminant gives a NaN root, and NaN compares false."""
    cox = packed[0] - ox[:, None]
    coy = packed[1] - oy[:, None]
    coz = packed[2] - oz[:, None]
    nb = cox * dx[:, None] + coy * dy[:, None] + coz * dz[:, None]
    c = cox * cox + coy * coy + coz * coz - packed[3]
    sq = sqrt(nb * nb - c)
    t1 = nb - sq
    t2 = nb + sq
    t = torch.where(t1 > t_min, t1, t2)
    t = torch.where(t > t_min, t, float("inf"))
    bt, best = torch.min(t, dim=1)  # first minimum wins
    return best, bt


def closest_hit_record(packed: torch.Tensor, best, bt, ox, oy, oz,
                       dx, dy, dz) -> HitRecord:
    """Unpack the winning row's payload (megakernel._closest_hit_record):
    albedo decoded by a multiply with float32(1/255), ref_idx = param for
    dielectrics and 1 otherwise, fuzz = param."""
    cx, cy, cz, ivr, albp, mtp = (packed[r][best] for r in (0, 1, 2, 4, 5, 6))
    hit = bt < _BIG
    t = torch.where(hit, bt, 1.0)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    mt_f = torch.floor(mtp * (1.0 / 32.0))
    mt_i = mt_f.to(torch.int32)
    mparam = mtp - mt_f * 32.0
    a_r = torch.floor(albp * (1.0 / 65536.0))
    rem = albp - a_r * 65536.0
    a_g = torch.floor(rem * (1.0 / 256.0))
    a_b = rem - a_g * 256.0
    inv255 = 1.0 / 255.0
    return HitRecord(
        hit=hit, t=t, px=px, py=py, pz=pz,
        nx=(px - cx) * ivr, ny=(py - cy) * ivr, nz=(pz - cz) * ivr,
        mat_type=mt_i,
        albedo_x=a_r * inv255, albedo_y=a_g * inv255, albedo_z=a_b * inv255,
        fuzz=mparam, ref_idx=torch.where(mt_i == 2, mparam, 1.0))


def _span(cfg: RenderConfig, sample_span):
    s_lo, s_hi = (0, cfg.spp) if sample_span is None else sample_span
    if not 0 <= s_lo <= s_hi <= cfg.spp:
        raise ValueError(f"sample_span {sample_span} outside [0, {cfg.spp}]")
    return s_lo, s_hi


def trace_respawn_reference(packed: torch.Tensor, cam: torch.Tensor, pid, x,
                            y, cfg: RenderConfig, sample_span=None):
    """Plain version of the respawn kernel, on any device.

    pid: int32[N] pixel ids (y * width + x); lanes with pid >= cfg.num_pixels
    are padding and never traced or counted. x, y: float32[N] pixel
    coordinates. For each sample s of sample_span = (s_lo, s_hi) (default
    all of [0, spp)) it generates the rays of rid = pid * spp + s, traces
    them with the packed-table sweep, and adds each sample's radiance in
    sample order.

    Returns ((rr, rg, rb) float32[N] sample sums, cnt int32[N] rays traced)."""
    s_lo, s_hi = _span(cfg, sample_span)
    camera = unpack_camera(cam)
    t_min = cfg.t_min

    def intersector(ox, oy, oz, dx, dy, dz):
        best, bt = sweep(packed, ox, oy, oz, dx, dy, dz, t_min)
        return closest_hit_record(packed, best, bt, ox, oy, oz, dx, dy, dz)

    active = pid < cfg.num_pixels
    sums = [torch.zeros_like(x) for _ in range(3)]
    cnt = torch.zeros_like(pid, dtype=torch.int32)
    for s in range(s_lo, s_hi):
        rid = pid * cfg.spp + s
        rays = primary_rays(camera, cfg, x, y, rid)
        rad, count = trace(None, *rays, cfg.seed, rid,
                           max_bounces=cfg.max_bounces, t_min=t_min,
                           active=active, intersector=intersector)
        sums = [acc + r for acc, r in zip(sums, rad)]
        cnt += count
    return tuple(sums), cnt


def check_tensor(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_table_fits(s_count):
    if NUM_SPHERE_ROWS * 4 * s_count > _MAX_TABLE_BYTES:
        raise ValueError(f"{s_count} sphere rows need "
                         f"{NUM_SPHERE_ROWS * 4 * s_count} B of shared memory; "
                         f"a block has at most {_MAX_TABLE_BYTES}")


def _respawn_kernel():
    lib = build.load("respawn", "respawn.cu")
    fn = lib.rays1_respawn_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, i, i, i, i, i, i, f, ctypes.c_uint32, f, f,
                   p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def trace_respawn(packed: torch.Tensor, cam: torch.Tensor,
                  cfg: RenderConfig, sample_span=None):
    """Trace every sample of every pixel of cfg's image.

    packed: float32 (7, S) from pack_spheres; cam: float32 (19,) from
    pack_camera; both on one device. sample_span: optional (s_lo, s_hi)
    slice of [0, spp).

    Returns ((rr, rg, rb) float32[H*W] per-pixel sample sums in image order,
    row 0 = bottom; cnt int32[H*W] rays traced per pixel; total int64 0-dim
    tensor, the ray count). CUDA tensors launch the kernel of csrc/respawn.cu
    on the current stream; CPU tensors run trace_respawn_reference."""
    global LAUNCHES
    device = packed.device
    s_count = packed.shape[1] if packed.dim() == 2 else -1
    check_tensor("packed", packed, torch.float32, (NUM_SPHERE_ROWS, s_count),
                 device)
    check_tensor("cam", cam, torch.float32, (CAMERA_FLOATS,), device)
    s_lo, s_hi = _span(cfg, sample_span)
    npix = cfg.num_pixels

    if device.type == "cpu":
        pid = torch.arange(npix, dtype=torch.int32)
        x = (pid % cfg.width).to(torch.float32)
        y = (pid // cfg.width).to(torch.float32)
        rad, cnt = trace_respawn_reference(packed, cam, pid, x, y, cfg,
                                           (s_lo, s_hi))
        return rad, cnt, cnt.sum(dtype=torch.int64)
    if device.type != "cuda":
        raise ValueError(f"trace_respawn runs on cuda or cpu, not {device}")
    _check_table_fits(s_count)
    if npix * cfg.spp >= 2 ** 31:
        raise ValueError("ray ids must fit in int32")

    fn = _respawn_kernel()
    rr, rg, rb = (torch.empty(npix, dtype=torch.float32, device=device)
                  for _ in range(3))
    cnt = torch.empty(npix, dtype=torch.int32, device=device)
    total = torch.zeros(1, dtype=torch.int64, device=device)
    err = fn(packed.data_ptr(), s_count, cam.data_ptr(), cfg.width,
             cfg.height, cfg.spp, s_lo, s_hi, cfg.max_bounces, cfg.t_min,
             cfg.seed, 1.0 / cfg.width, 1.0 / cfg.height,
             rr.data_ptr(), rg.data_ptr(), rb.data_ptr(), cnt.data_ptr(),
             total.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"respawn kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return (rr, rg, rb), cnt, total[0]


def trace_topology_reference(packed: torch.Tensor, ox, oy, oz, dx, dy, dz,
                             ray_id, cfg: RenderConfig):
    """Plain version of the one-shot topology kernel, on any device: the
    packed-table sweep under render.integrator.trace, in the per-bounce
    order of megakernel._make_bounce. Lanes with ray_id >=
    cfg.num_primary_rays are padding, never traced or counted.

    Returns ((rr, rg, rb) float32[N] radiance, cnt int32[N] rays traced,
    topo int32[max_bounces+1, N]: the winning row for a live lane that hit,
    -1 otherwise)."""
    planes = []

    def intersector(*rays):
        best, bt = sweep(packed, *rays, cfg.t_min)
        rec = closest_hit_record(packed, best, bt, *rays)
        planes.append(torch.where(rec.hit, best.to(torch.int32), -1))
        return rec

    rad, cnt = trace(None, ox, oy, oz, dx, dy, dz, cfg.seed, ray_id,
                     max_bounces=cfg.max_bounces, t_min=cfg.t_min,
                     active=ray_id < cfg.num_primary_rays,
                     intersector=intersector)
    topo = torch.full((cfg.max_bounces + 1, ox.shape[0]), -1,
                      dtype=torch.int32, device=ox.device)
    # A lane is alive at bounce b exactly when it was counted more than b
    # times: it dies once and stays dead.
    for b, plane in enumerate(planes):
        topo[b] = torch.where(cnt > b, plane, -1)
    return rad, cnt, topo


def check_rays(n: int, device, **planes):
    """Raise unless every plane is a contiguous length-n tensor on device:
    float32, or int32 for ray_id."""
    for name, t in planes.items():
        dtype = torch.int32 if name == "ray_id" else torch.float32
        check_tensor(name, t, dtype, (n,), device)


def _oneshot_kernel():
    lib = build.load("oneshot", "oneshot.cu")
    fn = lib.rays1_oneshot_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i, f, ctypes.c_uint32,
                   p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def trace_topology(packed: torch.Tensor, ox, oy, oz, dx, dy, dz, ray_id,
                   cfg: RenderConfig):
    """Trace N given primary rays, recording each bounce's winning row.

    packed: float32 (7, S) from pack_spheres; ox..dz: float32[N] primary
    rays; ray_id: int32[N] global ray ids in any order (ids >=
    cfg.num_primary_rays are padding). All on one device.

    Returns ((rr, rg, rb) float32[N] per-ray radiance; cnt int32[N] rays
    traced per lane; total int64 0-dim tensor; topo int32[max_bounces+1, N]
    winning raw row per bounce for live lanes that hit, -1 otherwise). CUDA
    tensors launch the kernel of csrc/oneshot.cu on the current stream,
    which writes every topology plane itself; CPU tensors run
    trace_topology_reference."""
    global ONESHOT_LAUNCHES
    device = packed.device
    n = ox.shape[0] if ox.dim() == 1 else -1
    s_count = packed.shape[1] if packed.dim() == 2 else -1
    check_tensor("packed", packed, torch.float32, (NUM_SPHERE_ROWS, s_count),
                 device)
    check_rays(n, device, ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz,
               ray_id=ray_id)
    if device.type == "cpu":
        rad, cnt, topo = trace_topology_reference(packed, ox, oy, oz, dx, dy,
                                                  dz, ray_id, cfg)
        return rad, cnt, cnt.sum(dtype=torch.int64), topo
    if device.type != "cuda":
        raise ValueError(f"trace_topology runs on cuda or cpu, not {device}")
    _check_table_fits(s_count)

    rr, rg, rb = (torch.empty(n, dtype=torch.float32, device=device)
                  for _ in range(3))
    cnt = torch.empty(n, dtype=torch.int32, device=device)
    topo = torch.empty((cfg.max_bounces + 1, n), dtype=torch.int32,
                       device=device)
    total = torch.zeros(1, dtype=torch.int64, device=device)
    if n == 0:
        return (rr, rg, rb), cnt, total[0], topo
    fn = _oneshot_kernel()
    err = fn(packed.data_ptr(), s_count, ox.data_ptr(), oy.data_ptr(),
             oz.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(),
             ray_id.data_ptr(), n, cfg.num_primary_rays, cfg.max_bounces,
             cfg.t_min, cfg.seed, rr.data_ptr(), rg.data_ptr(), rb.data_ptr(),
             cnt.data_ptr(), topo.data_ptr(), total.data_ptr(),
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"oneshot kernel launch failed: cudaError {err}")
    ONESHOT_LAUNCHES += 1
    return (rr, rg, rb), cnt, total[0], topo
