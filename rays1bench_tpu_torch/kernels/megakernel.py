"""The port's path-tracing kernels and their plain versions
(rays1bench_tpu/kernels/megakernel.py).

`trace_respawn` is the counterpart of `trace_pallas_respawn`: every sample
of every pixel traced to completion, returning per-pixel radiance sums and
per-pixel ray counts in image order. `trace_oneshot` and `trace_topology`
are the counterparts of `trace_pallas` without and with emit_topology:
every given primary ray (from 16 table rows up, each lane takes the next
ray when its ray ends), per-ray radiance and counts in the caller's
order, and with
topology the winning sphere row of every bounce (the gradient path's
forward). `trace_wavefront` is the counterpart of `trace_pallas_wavefront`:
phases of bounces (`wavefront_phase`, one launch of the phase kernel
each; from 16 table rows up, each lane takes the next listed ray when its
ray ends) with the live rays listed between phases. `generate_rays` makes
the primary rays of given ray ids, which the last three take; it has no
Pallas counterpart (the JAX package's raygen is jnp, fused by XLA). On a
CUDA tensor each launches its kernel (csrc/respawn.cu, csrc/oneshot.cu,
csrc/phase.cu, csrc/raygen.cu, built by kernels/build.py); on a CPU tensor
it runs its plain torch version (`trace_respawn_reference`,
`trace_topology_reference`, `wavefront_phase_reference`,
render.pipeline.primary_rays_from_ids). There is no fallback between the
two: a CUDA input launches the kernel or raises.

All read the same packed tables as the Pallas kernels, kept bit for bit:
the (7, S) sphere table of `pack_spheres` (placeholder radius_sq poisoned to
-1e30, 8-bit albedo as r*65536 + g*256 + b, material and parameter as
mt*32 + param) and the 19-float camera row of `pack_camera`. `ref_idx` and
`fuzz` therefore decode to the same floats as in the JAX kernel, which is
what makes ray counts comparable. Dropped TPU workarounds: the pixel-tile
slot permutation (the kernels read and write in ray or image order),
`tile_rays`, `unroll`, `sync_every` and the wavefront's row-granular
argsort compaction (see trace_wavefront). Without `sync_every` there is no
overshoot past max_bounces, so the topology write guard of the Pallas
kernel has nothing to guard.

`debug_iters` (trace_respawn, trace_oneshot) counts serial work as the
Pallas kernels' per-tile `while_loop` trips do, but per warp, the unit
that runs serially on the card: the sum over warps of their loop's trips,
as one int64 (the kernels' kIters instantiations). A warp runs as long as
its busiest lane, so the respawn kernel's trips are a function of the
per-pixel counts on its 8x4-pixel warps (`respawn_iters_reference`), and
so are the one-shot kernel's below kNestRows rows, a thread per ray on
warps of 32 consecutive rays (`oneshot_iters_reference`). From kNestRows
rows up the one-shot kernel's lanes refill from a counter, and its trips
depend on the order the lanes take the rays in: the plain version gives
the fewest any order could take, and the kernel is held to it as a bound.
The phase kernel keeps no counter.

`trace_topology` and `trace_oneshot` take the soft-silhouette mode
(cfg.soft_silhouette > 0), as the Pallas `_kernel` does with `soft_eps`:
after the hard sweep a second, graze sweep finds each ray's best near miss
in front of its hit (`graze_sweep`), a graze inside the band replaces the
winner (`soft_sweep`), the hit record gains the soft fields
(`soft_hit_record`) and the bounce takes the two-branch draw. The respawn
and wavefront engines are hard only and refuse it, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from rays1bench_tpu_torch.core import rng as rng_mod
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.core.vecmath import f32, safe_sqrt, sqrt
from rays1bench_tpu_torch.kernels import build
from rays1bench_tpu_torch.render.camera import Camera
from rays1bench_tpu_torch.render.integrator import (bounce_step,
                                                    initial_state, trace)
from rays1bench_tpu_torch.render.intersect import (HitRecord, SoftHitRecord,
                                                   near_cut, soft_fields)
from rays1bench_tpu_torch.render.pipeline import (primary_rays,
                                                  primary_rays_from_ids)
from rays1bench_tpu_torch.scene.spheres import PreparedSpheres
from rays1bench_tpu_torch.utils import profiling

NUM_SPHERE_ROWS = 7
CAMERA_FLOATS = 19
# Camera's tensors in field order, as autograd Functions take them.
CAMERA_FIELDS = tuple(f.name for f in dataclasses.fields(Camera))
_BIG = 3.0e38
# Dynamic shared memory a block may use on Hopper (227 KB), less the
# kernel's static shared arrays.
_MAX_TABLE_BYTES = 232448 - 1024

# Kernel launches made by trace_respawn, by trace_topology and
# trace_oneshot (one kernel), by wavefront_phase (one per call on a CUDA
# tensor that has rays to advance) and by generate_rays (one per call on a
# CUDA tensor that has rays); those of the respawn and one-shot kernels'
# kIters instantiations (debug_iters=True) apart.
LAUNCHES = 0
ONESHOT_LAUNCHES = 0
PHASE_LAUNCHES = 0
RAYGEN_LAUNCHES = 0
RESPAWN_ITERS_LAUNCHES = 0
ONESHOT_ITERS_LAUNCHES = 0
# The kernels' warp layouts, for the plain versions of their trip counts:
# the respawn kernel's warps cover WARP_PIXELS (width, height) of the image
# and its blocks BLOCK_ROWS rows (csrc/respawn.cu); the one-shot kernel
# takes a thread per ray below NEST_ROWS table rows (r1b::kNestRows).
WARP_LANES = 32
WARP_PIXELS = (8, 4)
BLOCK_ROWS = 8
NEST_ROWS = 16
# Float planes of the wavefront state: ox oy oz dx dy dz ar ag ab rr rg rb.
STATE_PLANES = 12


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


def _raygen_kernel():
    lib = build.load("raygen", "raygen.cu")
    fn = lib.rays1_raygen_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, i, i, ctypes.c_uint32, f, f, p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def camera_vjp(cam_tensors, cfg: RenderConfig, ray_id, ray_cts, need):
    """The cotangents of the camera's tensors (Camera's fields in order)
    given those of the six ray planes of ray_id: the plain raygen
    (primary_rays_from_ids) replayed under autograd on detached copies.
    None where `need` is false, zeros where a tensor does not reach the
    rays."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in cam_tensors]
        again = primary_rays_from_ids(Camera(*leaves), cfg, ray_id)
        got = torch.autograd.grad(again, leaves, ray_cts, allow_unused=True)
    return [None if not n else (torch.zeros_like(t) if g is None else g)
            for n, g, t in zip(need, got, leaves)]


class _Raygen(torch.autograd.Function):
    """generate_rays under autograd. The forward launches the kernel of
    csrc/raygen.cu on a CUDA tensor (none for an empty ray_id) and runs
    primary_rays_from_ids on a CPU one; the backward is camera_vjp.
    Autograd records it only where a camera tensor requires grad
    (grad/inverse.fit_camera); elsewhere its outputs have no grad_fn."""

    @staticmethod
    def forward(ctx, cfg, ray_id, *cam_tensors):
        global RAYGEN_LAUNCHES
        ctx.cfg = cfg
        ctx.save_for_backward(ray_id, *cam_tensors)
        camera = Camera(*cam_tensors)
        device = ray_id.device
        n = ray_id.shape[0] if ray_id.dim() == 1 else -1
        check_rays(n, device, ray_id=ray_id)
        if device.type == "cpu":
            return tuple(r.contiguous()
                         for r in primary_rays_from_ids(camera, cfg, ray_id))
        if device.type != "cuda":
            raise ValueError(f"generate_rays runs on cuda or cpu, not "
                             f"{device}")
        cam = pack_camera(camera)
        check_tensor("cam", cam, torch.float32, (CAMERA_FLOATS,), device)
        rays = tuple(torch.empty(n, dtype=torch.float32, device=device)
                     for _ in range(6))
        if n:
            err = _raygen_kernel()(
                ray_id.data_ptr(), n, cam.data_ptr(), cfg.width, cfg.spp,
                cfg.seed, 1.0 / cfg.width, 1.0 / cfg.height,
                *(r.data_ptr() for r in rays),
                torch.cuda.current_stream(device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"raygen kernel launch failed: cudaError "
                                   f"{err}")
            RAYGEN_LAUNCHES += 1
        return rays

    @staticmethod
    def backward(ctx, *ray_cts):
        ray_id, *cam_tensors = ctx.saved_tensors
        return (None, None) + tuple(camera_vjp(
            cam_tensors, ctx.cfg, ray_id, ray_cts, ctx.needs_input_grad[2:]))


def generate_rays(camera: Camera, cfg: RenderConfig, ray_id):
    """The primary rays of the given global ids: ray_id int32[N] in any
    order (ids >= cfg.num_primary_rays are padding and get what
    primary_rays_from_ids gives them). Returns (ox, oy, oz, dx, dy, dz),
    float32[N] each, contiguous.

    CUDA tensors launch the kernel of csrc/raygen.cu on the current stream,
    whose planes equal primary_rays_from_ids' bit for bit; the camera's
    tensors must lie on ray_id's device. CPU tensors run
    primary_rays_from_ids. Either way the camera's gradient is that of
    primary_rays_from_ids (camera_vjp), taken only where a camera tensor
    requires grad. While utils/profiling records, counts the rays the
    kernel made under "raygen_kernel_rays" (0 on the CPU)."""
    rays = _Raygen.apply(cfg, ray_id,
                         *(getattr(camera, f) for f in CAMERA_FIELDS))
    profiling.count("raygen_kernel_rays",
                    ray_id.shape[0] if ray_id.is_cuda else 0)
    return rays


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


def _material(albp, mtp):
    """Decode the packed payload: albedo by a multiply with float32(1/255),
    ref_idx = param for dielectrics and 1 otherwise, fuzz = param."""
    mt_f = torch.floor(mtp * (1.0 / 32.0))
    mt_i = mt_f.to(torch.int32)
    mparam = mtp - mt_f * 32.0
    a_r = torch.floor(albp * (1.0 / 65536.0))
    rem = albp - a_r * 65536.0
    a_g = torch.floor(rem * (1.0 / 256.0))
    a_b = rem - a_g * 256.0
    inv255 = 1.0 / 255.0
    return dict(mat_type=mt_i, albedo_x=a_r * inv255, albedo_y=a_g * inv255,
                albedo_z=a_b * inv255, fuzz=mparam,
                ref_idx=torch.where(mt_i == 2, mparam, 1.0))


def closest_hit_record(packed: torch.Tensor, best, bt, ox, oy, oz,
                       dx, dy, dz) -> HitRecord:
    """Unpack the winning row's payload (megakernel._closest_hit_record)."""
    cx, cy, cz, ivr, albp, mtp = (packed[r][best] for r in (0, 1, 2, 4, 5, 6))
    hit = bt < _BIG
    t = torch.where(hit, bt, 1.0)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    return HitRecord(
        hit=hit, t=t, px=px, py=py, pz=pz,
        nx=(px - cx) * ivr, ny=(py - cy) * ivr, nz=(pz - cz) * ivr,
        **_material(albp, mtp))


def graze_sweep(packed: torch.Tensor, ox, oy, oz, dx, dy, dz, bt,
                t_min: float):
    """The soft mode's second sweep (megakernel._make_intersect's
    make_graze_step), all rows at once: among rows with radius_sq > -1e29
    (not placeholders) that the ray misses, edge = sqrt(max(rsq, 0)) -
    sqrt(max(|co|^2 - nb^2, 1e-20)) <= 0, with closest approach nb in
    (t_min, bt), the first row with the largest edge. Returns (row int64[N],
    edge float32[N], -inf where no row qualifies; nb float32[N] of that
    row)."""
    rsq = packed[3]
    cox = packed[0] - ox[:, None]
    coy = packed[1] - oy[:, None]
    coz = packed[2] - oz[:, None]
    nb = cox * dx[:, None] + coy * dy[:, None] + coz * dz[:, None]
    co2 = cox * cox + coy * coy + coz * coz
    edge = (sqrt(torch.clamp_min(rsq, 0.0))
            - sqrt(torch.clamp_min(co2 - nb * nb, 1e-20)))
    graze = ((rsq > -1e29) & (nb > t_min) & (edge <= 0.0)
             & (nb < bt[:, None]))
    be, row = torch.max(torch.where(graze, edge, float("-inf")), dim=1)
    return row, be, nb.gather(1, row[:, None])[:, 0]


def soft_sweep(packed: torch.Tensor, ox, oy, oz, dx, dy, dz, t_min: float,
               soft_eps: float):
    """The hard sweep, the graze sweep and the promotion merge: a lane whose
    best graze edge is above -9.2 * soft_eps takes the grazed row, at t =
    nb. Returns (row int64[N], t float32[N], +inf on a miss; promoted
    bool[N])."""
    best, bt = sweep(packed, ox, oy, oz, dx, dy, dz, t_min)
    row, be, nb = graze_sweep(packed, ox, oy, oz, dx, dy, dz, bt, t_min)
    near = be > near_cut(soft_eps)
    return torch.where(near, row, best), torch.where(near, nb, bt), near


def soft_hit_record(packed: torch.Tensor, best, bt, ox, oy, oz, dx, dy, dz,
                    t_min: float, soft_eps: float) -> SoftHitRecord:
    """Soft-mode hit record of the merged winner
    (megakernel._soft_hit_record): t recomputed from the row with
    safe_sqrt and render/intersect.soft_fields (IEEE 1 / sqrt where the JAX
    kernel has rsqrt), as hit_record_from_index builds them. hit = bt <
    3e38."""
    cx, cy, cz, rsq, ivr, albp, mtp = (packed[r][best] for r in range(7))
    gx, gy, gz = cx - ox, cy - oy, cz - oz
    nb = gx * dx + gy * dy + gz * dz
    c_j = gx * gx + gy * gy + gz * gz - rsq
    sq = safe_sqrt(nb * nb - c_j)
    t1 = nb - sq
    t = torch.where(t1 > t_min, t1, nb + sq)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    (nx, ny, nz), soft = soft_fields(
        ox, oy, oz, dx, dy, dz, rsq, nb, c_j, sq, (px - cx) * ivr,
        (py - cy) * ivr, (pz - cz) * ivr, soft_eps)
    return SoftHitRecord(hit=bt < _BIG, t=t, px=px, py=py, pz=pz, nx=nx,
                         ny=ny, nz=nz, **soft, **_material(albp, mtp))


def packed_intersector(packed: torch.Tensor, t_min: float):
    """intersector(ox..dz) -> HitRecord of the packed-table sweep, for
    render.integrator."""
    def intersector(ox, oy, oz, dx, dy, dz):
        best, bt = sweep(packed, ox, oy, oz, dx, dy, dz, t_min)
        return closest_hit_record(packed, best, bt, ox, oy, oz, dx, dy, dz)
    return intersector


def hard_only(cfg: RenderConfig, engine: str):
    """Raise on the soft renderer: the respawn and wavefront engines are hard
    only (megakernel.py:894, :999)."""
    if cfg.soft_silhouette:
        raise ValueError(f"the {engine} engine is the hard renderer; the soft "
                         f"silhouette mode runs in the one-shot kernel "
                         f"(trace_topology, trace_oneshot)")


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
    hard_only(cfg, "respawn")
    s_lo, s_hi = _span(cfg, sample_span)
    camera = unpack_camera(cam)
    t_min = cfg.t_min
    intersector = packed_intersector(packed, t_min)
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


def _rows(cfg: RenderConfig, rows):
    rows = (0, cfg.height) if rows is None else tuple(rows)
    y_lo, y_hi, stride = rows + (1,) if len(rows) == 2 else rows
    if not (0 <= y_lo <= y_hi <= cfg.height and stride >= 1
            and (y_lo % BLOCK_ROWS == 0 or y_lo == y_hi)):
        raise ValueError(f"rows {rows}: a band [y_lo, y_hi) of [0, "
                         f"{cfg.height}] starting at a multiple of "
                         f"{BLOCK_ROWS}, and a block stride of 1 or more")
    return y_lo, y_hi, stride


def block_rows(cfg: RenderConfig, rows=None) -> torch.Tensor:
    """The image rows (int64, in image order) that trace_respawn's `rows`
    covers: of the BLOCK_ROWS-row block-rows from y_lo, every stride-th,
    each cut at y_hi. Its outputs hold these rows' pixels in this order."""
    y_lo, y_hi, stride = _rows(cfg, rows)
    y = torch.arange(y_lo, y_hi)
    return y[(y - y_lo) // BLOCK_ROWS % stride == 0]


def respawn_iters_reference(cnt: torch.Tensor, width: int) -> torch.Tensor:
    """Plain version of the respawn kernel's trip count: cnt, the
    per-pixel counts of whole rows in image order (a frame, or the outputs
    of trace_respawn's `rows`, whole BLOCK_ROWS-row blocks but for the
    last), cut into the kernel's 8x4-pixel warps; each warp runs as long
    as its busiest pixel. Returns the sum over warps of their largest
    count (int64 0-dim)."""
    ww, wh = WARP_PIXELS
    c = cnt.reshape(-1, width).to(torch.int64)
    c = torch.nn.functional.pad(c, (0, -width % ww, 0, -c.shape[0] % wh))
    c = c.reshape(c.shape[0] // wh, wh, c.shape[1] // ww, ww)
    return c.amax(dim=(1, 3)).sum()


def oneshot_iters_reference(cnt: torch.Tensor, s_count: int) -> torch.Tensor:
    """Plain version of the one-shot kernel's trip count, from its per-ray
    counts in input order. Below NEST_ROWS table rows (a thread per ray):
    the sum over warps of 32 consecutive rays of their largest count,
    which the kernel equals. From NEST_ROWS up (the flat loop, whose lanes
    refill from a counter): a ray holds a lane for max(count, 1) trips (a
    padding ray one), so no order takes fewer than ceil(sum / 32) trips;
    the kernel is held to that bound. Returns an int64 0-dim tensor."""
    c = cnt.to(torch.int64)
    if s_count >= NEST_ROWS:
        return (c.clamp_min(1).sum() + WARP_LANES - 1) // WARP_LANES
    c = torch.nn.functional.pad(c, (0, -c.shape[0] % WARP_LANES))
    return c.reshape(-1, WARP_LANES).amax(dim=1).sum()


def check_tensor(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_table_fits(s_count, rows=NUM_SPHERE_ROWS):
    """Raise unless a (rows, s_count) float32 table fits in a block's
    dynamic shared memory."""
    if rows * 4 * s_count > _MAX_TABLE_BYTES:
        raise ValueError(f"{s_count} sphere rows need "
                         f"{rows * 4 * s_count} B of shared memory; "
                         f"a block has at most {_MAX_TABLE_BYTES}")


def _respawn_kernel():
    lib = build.load("respawn", "respawn.cu")
    fn = lib.rays1_respawn_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, i, i, i, i, i, i, f, ctypes.c_uint32, f, f,
                   p, p, p, p, p, i, p, i, p]
    fn.restype = ctypes.c_int
    return fn


def trace_respawn(packed: torch.Tensor, cam: torch.Tensor,
                  cfg: RenderConfig, sample_span=None, rows=None,
                  debug_iters: bool = False):
    """Trace every sample of every pixel of cfg's image, or of a set of
    its rows.

    packed: float32 (7, S) from pack_spheres; cam: float32 (19,) from
    pack_camera; both on one device. sample_span: optional (s_lo, s_hi)
    slice of [0, spp). rows: optional (y_lo, y_hi) band of image rows, y_lo
    a multiple of BLOCK_ROWS, or (y_lo, y_hi, stride): of the band's
    BLOCK_ROWS-row block-rows every stride-th, from the first (a sharded
    render's rank, parallel/shard.band); default all. block_rows gives the
    rows a set covers.

    Returns ((rr, rg, rb) float32[P] per-pixel sample sums of the set's P
    pixels in image order, row y_lo first (row 0 = bottom); cnt int32[P]
    rays traced per pixel; total int64 0-dim tensor, the ray count), and
    with debug_iters the warps' loop trips summed (int64 0-dim; the
    kernel's kIters instantiation, respawn_iters_reference on the CPU).
    CUDA tensors launch the kernel of csrc/respawn.cu on the current stream
    (none for an empty set); CPU tensors run trace_respawn_reference."""
    global LAUNCHES, RESPAWN_ITERS_LAUNCHES
    hard_only(cfg, "respawn")
    device = packed.device
    s_count = packed.shape[1] if packed.dim() == 2 else -1
    check_tensor("packed", packed, torch.float32, (NUM_SPHERE_ROWS, s_count),
                 device)
    check_tensor("cam", cam, torch.float32, (CAMERA_FLOATS,), device)
    s_lo, s_hi = _span(cfg, sample_span)
    y_lo, y_hi, stride = _rows(cfg, rows)
    # block_rows' count in integers: no tensor op on the launch's path.
    npix = cfg.width * sum(min(BLOCK_ROWS, y_hi - b) for b in range(
        y_lo, y_hi, stride * BLOCK_ROWS))

    if device.type == "cpu":
        pid = (block_rows(cfg, rows)[:, None] * cfg.width
               + torch.arange(cfg.width)).reshape(-1).to(torch.int32)
        x = (pid % cfg.width).to(torch.float32)
        y = (pid // cfg.width).to(torch.float32)
        rad, cnt = trace_respawn_reference(packed, cam, pid, x, y, cfg,
                                           (s_lo, s_hi))
        out = (rad, cnt, cnt.sum(dtype=torch.int64))
        return out + (respawn_iters_reference(cnt, cfg.width),) \
            if debug_iters else out
    if device.type != "cuda":
        raise ValueError(f"trace_respawn runs on cuda or cpu, not {device}")
    check_table_fits(s_count)
    if cfg.num_pixels * cfg.spp >= 2 ** 31:
        raise ValueError("ray ids must fit in int32")

    rr, rg, rb = (torch.empty(npix, dtype=torch.float32, device=device)
                  for _ in range(3))
    cnt = torch.empty(npix, dtype=torch.int32, device=device)
    # The 64-bit ray total, then the trip total: one fill.
    scratch = torch.zeros(2 if debug_iters else 1, dtype=torch.int64,
                          device=device)
    if npix:
        err = _respawn_kernel()(
            packed.data_ptr(), s_count, cam.data_ptr(), cfg.width, y_hi,
            cfg.spp, s_lo, s_hi, cfg.max_bounces, cfg.t_min, cfg.seed,
            1.0 / cfg.width, 1.0 / cfg.height, rr.data_ptr(), rg.data_ptr(),
            rb.data_ptr(), cnt.data_ptr(), scratch.data_ptr(), y_lo,
            scratch.data_ptr() + 8 if debug_iters else None, stride,
            torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"respawn kernel launch failed: cudaError "
                               f"{err}")
        if debug_iters:
            RESPAWN_ITERS_LAUNCHES += 1
        else:
            LAUNCHES += 1
    out = ((rr, rg, rb), cnt, scratch[0])
    return out + (scratch[1],) if debug_iters else out


def trace_topology_reference(packed: torch.Tensor, ox, oy, oz, dx, dy, dz,
                             ray_id, cfg: RenderConfig, stats=None):
    """Plain version of the one-shot topology kernel, on any device: the
    packed-table sweep under render.integrator.trace, in the per-bounce
    order of megakernel._make_bounce, with the soft mode's soft_sweep,
    soft_hit_record and two-branch draw when cfg.soft_silhouette > 0. Lanes
    with ray_id >= cfg.num_primary_rays are padding, never traced or
    counted.

    stats: optional dict; in soft mode, stats["promoted"] and
    stats["pass_through"] are increased by the live lanes promoted to a
    graze and the live hits that drew the pass-through branch, and
    stats["hard_roots"] and stats["graze_roots"] by the square roots the
    kernel's two sweeps take for the live lanes (sweep_roots).

    Returns ((rr, rg, rb) float32[N] radiance, cnt int32[N] rays traced,
    topo int32[max_bounces+1, N]: the winning row for a live lane that hit,
    -1 otherwise)."""
    soft = cfg.soft_silhouette
    planes, marks = [], []

    def intersector(*rays):
        if soft:
            best, bt, near = soft_sweep(packed, *rays, cfg.t_min, soft)
            rec = soft_hit_record(packed, best, bt, *rays, cfg.t_min, soft)
        else:
            best, bt = sweep(packed, *rays, cfg.t_min)
            rec = closest_hit_record(packed, best, bt, *rays)
        if soft and stats is not None:
            u = rng_mod.uniform01(cfg.seed, ray_id, len(planes),
                                  rng_mod.Slots.SILHOUETTE_P)
            marks.append((near, rec.hit & ~(u < rec.cover),
                          *sweep_roots(packed, *rays, cfg.t_min)))
        planes.append(torch.where(rec.hit, best.to(torch.int32), -1))
        return rec

    rad, cnt = trace(None, ox, oy, oz, dx, dy, dz, cfg.seed, ray_id,
                     max_bounces=cfg.max_bounces, t_min=cfg.t_min,
                     active=ray_id < cfg.num_primary_rays,
                     intersector=intersector, soft_eps=soft)
    topo = torch.full((cfg.max_bounces + 1, ox.shape[0]), -1,
                      dtype=torch.int32, device=ox.device)
    # A lane is alive at bounce b exactly when it was counted more than b
    # times: it dies once and stays dead.
    for b, plane in enumerate(planes):
        topo[b] = torch.where(cnt > b, plane, -1)
    for b, mark in enumerate(marks):
        for key, m in zip(("promoted", "pass_through", "hard_roots",
                           "graze_roots"), mark):
            stats[key] = stats.get(key, 0) + int(torch.where(
                cnt > b, m, 0).sum(dtype=torch.int64))
    return rad, cnt, topo


def sweep_roots(packed: torch.Tensor, ox, oy, oz, dx, dy, dz, t_min: float):
    """Per ray, the square roots the soft kernel's two sweeps take
    (csrc/path_math.cuh sweep and graze_sweep): (rows whose discriminant
    is not negative, rows passing the graze sweep's cheap tests) as
    int64[N] each. For the kernel's operation count only."""
    _, bt = sweep(packed, ox, oy, oz, dx, dy, dz, t_min)
    cox = packed[0] - ox[:, None]
    coy = packed[1] - oy[:, None]
    coz = packed[2] - oz[:, None]
    nb = cox * dx[:, None] + coy * dy[:, None] + coz * dz[:, None]
    c = cox * cox + coy * coy + coz * coz - packed[3]
    hard = (~(nb * nb - c < 0.0)).sum(dim=1)
    graze = ((nb > t_min) & (nb < bt[:, None])
             & (packed[3] > -1e29)).sum(dim=1)
    return hard, graze


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
                   f, f, f, p, p, p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _oneshot(packed: torch.Tensor, ox, oy, oz, dx, dy, dz, ray_id,
             cfg: RenderConfig, emit_topology: bool,
             debug_iters: bool = False):
    """trace_oneshot and trace_topology: ((rr, rg, rb), cnt, total, topo or
    None, iters or None)."""
    global ONESHOT_LAUNCHES, ONESHOT_ITERS_LAUNCHES
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
        return (rad, cnt, cnt.sum(dtype=torch.int64),
                topo if emit_topology else None,
                oneshot_iters_reference(cnt, s_count) if debug_iters
                else None)
    if device.type != "cuda":
        raise ValueError(f"the one-shot kernel runs on cuda or cpu, not "
                         f"{device}")
    # Soft mode keeps an eighth row in shared memory: sqrt(max(rsq, 0)).
    check_table_fits(s_count, NUM_SPHERE_ROWS + (1 if cfg.soft_silhouette
                                                 else 0))

    rr, rg, rb = (torch.empty(n, dtype=torch.float32, device=device)
                  for _ in range(3))
    cnt = torch.empty(n, dtype=torch.int32, device=device)
    topo = (torch.empty((cfg.max_bounces + 1, n), dtype=torch.int32,
                        device=device) if emit_topology else None)
    # The 64-bit ray total, the kernel's int32 ray counter, then the trip
    # total: one fill.
    scratch = torch.zeros(3 if debug_iters else 2, dtype=torch.int64,
                          device=device)
    iters = scratch[2] if debug_iters else None
    if n == 0:
        return (rr, rg, rb), cnt, scratch[0], topo, iters
    soft = cfg.soft_silhouette
    fn = _oneshot_kernel()
    err = fn(packed.data_ptr(), s_count, ox.data_ptr(), oy.data_ptr(),
             oz.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(),
             ray_id.data_ptr(), n, cfg.num_primary_rays, cfg.max_bounces,
             cfg.t_min, cfg.seed, soft, f32(1.0 / soft) if soft else 0.0,
             near_cut(soft), rr.data_ptr(), rg.data_ptr(), rb.data_ptr(),
             cnt.data_ptr(), None if topo is None else topo.data_ptr(),
             scratch.data_ptr(), scratch.data_ptr() + 8,
             scratch.data_ptr() + 16 if debug_iters else None,
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"oneshot kernel launch failed: cudaError {err}")
    if debug_iters:
        ONESHOT_ITERS_LAUNCHES += 1
    else:
        ONESHOT_LAUNCHES += 1
    return (rr, rg, rb), cnt, scratch[0], topo, iters


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
    trace_topology_reference. cfg.soft_silhouette > 0 runs the soft mode
    in either; the topology then holds the promoted rows. No debug_iters
    here, as trace_pallas refuses it with emit_topology."""
    return _oneshot(packed, ox, oy, oz, dx, dy, dz, ray_id, cfg, True)[:4]


def trace_oneshot(packed: torch.Tensor, ox, oy, oz, dx, dy, dz, ray_id,
                  cfg: RenderConfig, debug_iters: bool = False):
    """Trace N given primary rays to completion: the
    one-shot render engine (trace_pallas without topology). Same inputs as
    trace_topology; returns ((rr, rg, rb) float32[N], cnt int32[N], total
    int64 0-dim tensor), and with debug_iters the warps' loop trips summed
    (int64 0-dim: the kernel's kIters instantiation; on the CPU
    oneshot_iters_reference). The kernel of csrc/oneshot.cu writes no
    topology and the wrapper allocates none; the plain version is
    trace_topology_reference."""
    rad, cnt, total, _, iters = _oneshot(packed, ox, oy, oz, dx, dy, dz,
                                         ray_id, cfg, False, debug_iters)
    return (rad, cnt, total, iters) if debug_iters else (rad, cnt, total)


def wavefront_spans(schedule, max_bounces: int):
    """The (b0, bend) bounce span of each phase that runs, with the JAX
    schedule's rules (megakernel.py:1049-1061): the cumulative budget is
    clamped to max_bounces+1, phases past it are not run, and the last
    phase is extended to max_bounces+1."""
    if not schedule or min(schedule) < 1:
        raise ValueError(f"a wavefront schedule is a non-empty tuple of "
                         f"positive bounce counts, not {schedule!r}")
    spans, b0 = [], 0
    for i, k in enumerate(schedule):
        if b0 > max_bounces:
            break
        bend = (max_bounces + 1 if i == len(schedule) - 1
                else min(b0 + k, max_bounces + 1))
        spans.append((b0, bend))
        b0 = bend
    return spans


def wavefront_state(ox, oy, oz, dx, dy, dz, ray_id, cfg: RenderConfig):
    """The carried state before the first phase: (state float32[12, N] =
    origin, direction, unit attenuation, zero radiance; alive bool[N],
    false on padding ids >= cfg.num_primary_rays; cnt int32[N] zeros)."""
    st = initial_state(ox, oy, oz, dx, dy, dz, ray_id < cfg.num_primary_rays,
                       ray_id)
    return torch.stack(st[:STATE_PLANES]), st[12], st[13]


def wavefront_phase_reference(packed: torch.Tensor, state, alive, ray_id, cnt,
                              slots, b0: int, bend: int, cfg: RenderConfig):
    """Plain version of the phase kernel, on any device, in place: advance
    the rays listed in slots (int32[M], or None for all) from absolute
    bounce b0 while b <= max_bounces and b < bend, through
    render.integrator.bounce_step with the packed-table sweep; write their
    state and alive flag back and add their counts to cnt."""
    sel = slice(None) if slots is None else slots.long()
    st = (*state[:, sel].unbind(0), alive[sel],
          torch.zeros_like(cnt[sel]))
    rid = ray_id[sel]
    intersector = packed_intersector(packed, cfg.t_min)
    for b in range(b0, min(bend, cfg.max_bounces + 1)):
        if not bool(st[12].any()):
            break
        st = bounce_step(st, b, cfg.seed, rid, cfg.max_bounces, intersector)
    state[:, sel] = torch.stack(st[:STATE_PLANES])
    alive[sel] = st[12]
    cnt[sel] += st[13]


def _phase_kernel():
    lib = build.load("phase", "phase.cu")
    fn = lib.rays1_phase_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, f, ctypes.c_uint32, p,
                   p]
    fn.restype = ctypes.c_int
    return fn


def wavefront_phase(packed: torch.Tensor, state, alive, ray_id, cnt, slots,
                    b0: int, bend: int, cfg: RenderConfig):
    """One wavefront phase, in place (the counterpart of one launch of
    _phase_kernel): the rays listed in slots advance over bounces
    [b0, bend). packed: float32 (7, S); state: float32 (12, N); alive:
    bool[N]; ray_id, cnt: int32[N]; slots: int32[M] or None (all N). CUDA
    tensors launch the kernel of csrc/phase.cu on the current stream (none
    when M is 0), whose lanes take list entries from a zeroed int32
    counter; CPU tensors run wavefront_phase_reference."""
    global PHASE_LAUNCHES
    hard_only(cfg, "wavefront")
    device = packed.device
    n = ray_id.shape[0] if ray_id.dim() == 1 else -1
    s_count = packed.shape[1] if packed.dim() == 2 else -1
    check_tensor("packed", packed, torch.float32, (NUM_SPHERE_ROWS, s_count),
                 device)
    check_tensor("state", state, torch.float32, (STATE_PLANES, n), device)
    check_tensor("alive", alive, torch.bool, (n,), device)
    check_tensor("cnt", cnt, torch.int32, (n,), device)
    check_rays(n, device, ray_id=ray_id)
    m = n if slots is None else slots.shape[0]
    if slots is not None:
        check_tensor("slots", slots, torch.int32, (m,), device)
    if device.type == "cpu":
        return wavefront_phase_reference(packed, state, alive, ray_id, cnt,
                                         slots, b0, bend, cfg)
    if device.type != "cuda":
        raise ValueError(f"wavefront_phase runs on cuda or cpu, not {device}")
    check_table_fits(s_count)
    if m == 0:
        return None
    work = torch.zeros(1, dtype=torch.int32, device=device)
    err = _phase_kernel()(
        packed.data_ptr(), s_count, state.data_ptr(), alive.data_ptr(),
        ray_id.data_ptr(), cnt.data_ptr(),
        None if slots is None else slots.data_ptr(), m, n, b0, bend,
        cfg.max_bounces, cfg.t_min, cfg.seed, work.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"phase kernel launch failed: cudaError {err}")
    PHASE_LAUNCHES += 1
    return None


def _wavefront(phase, packed, ox, oy, oz, dx, dy, dz, ray_id,
               cfg: RenderConfig, schedule):
    state, alive, cnt = wavefront_state(ox, oy, oz, dx, dy, dz, ray_id, cfg)
    for k, (b0, bend) in enumerate(wavefront_spans(schedule,
                                                   cfg.max_bounces)):
        # The compaction: a stable partition listing the live rays in slot
        # order (every ray in the first phase).
        slots = alive.nonzero()[:, 0].to(torch.int32) if k else None
        phase(packed, state, alive, ray_id, cnt, slots, b0, bend, cfg)
    return (state[9], state[10], state[11]), cnt, cnt.sum(dtype=torch.int64)


def trace_wavefront(packed: torch.Tensor, ox, oy, oz, dx, dy, dz, ray_id,
                    cfg: RenderConfig, schedule=(2, 3, 6)):
    """Trace N given primary rays in phases of bounces, listing the live
    rays between phases (trace_pallas_wavefront). Same inputs and outputs
    as trace_oneshot, and per ray bit for bit its result: ((rr, rg, rb)
    float32[N] in input slot order, cnt int32[N], total int64 0-dim).
    schedule: bounces per phase (wavefront_spans).

    Compaction is per ray: after each phase but the last, the live slots
    are listed (torch.nonzero, slot order kept) and the next phase's lanes
    take the listed rays one by one, each reading and writing its ray's
    state in place, so no state moves and the output needs no unpermute.
    The JAX package compacts 128-lane rows by argsort because per-ray
    argsort was too slow on its TPU (megakernel.py:978-985); on the GPU a
    dead ray costs nothing once it is off the list. Each listing reads its
    count back to the host. CUDA tensors launch csrc/phase.cu; CPU tensors
    run trace_wavefront_reference."""
    n = ox.shape[0] if ox.dim() == 1 else -1
    check_rays(n, packed.device, ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz,
               ray_id=ray_id)
    return _wavefront(wavefront_phase, packed, ox, oy, oz, dx, dy, dz,
                      ray_id, cfg, schedule)


def trace_wavefront_reference(packed: torch.Tensor, ox, oy, oz, dx, dy, dz,
                              ray_id, cfg: RenderConfig, schedule=(2, 3, 6)):
    """Plain version of trace_wavefront, on any device: the same schedule
    and compaction with wavefront_phase_reference for every phase."""
    return _wavefront(wavefront_phase_reference, packed, ox, oy, oz, dx, dy,
                      dz, ray_id, cfg, schedule)
