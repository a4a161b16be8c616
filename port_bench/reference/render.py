"""The plain reference path tracer, in plain PyTorch.

A frozen restatement of the semantics the program documents, written for
this benchmark and importing nothing of the program:
- the reference's integrator (src/latest/rayweek1.cpp:396-536, 757-759):
  thin-lens raygen with film jitter, closest hit over every sphere (first
  minimum wins), Lambertian / metal / dielectric scatter, sky on a miss,
  rays counted per radiance evaluation (rayweek1.cpp:517), at most
  max_bounces + 1 segments;
- the stateless RNG lattice keyed on (seed, ray id, bounce, slot) with the
  PCG-RXS-M-XS hash, 24-bit uniforms and the sincos polynomials;
- the kernels' packed sphere table: placeholder rows never hit, albedos on an
  8-bit grid (round(clamp(a, 0, 1) * 255) times float32(1 / 255)), and fuzz
  and ref_idx as decoded from the float32 word mat_type * 32 + param.

Every ray is independent, so any subset of ray ids can be traced, in
chunks, with the lanes that are still alive compacted each bounce: that
changes no ray. `dtype` is the precision of every floating-point tensor
(float32 is the configuration's; bfloat16 is the control's).

trace_rays returns each ray's radiance and ray count, and with record=True
what the fit's reference needs: the table row whose albedo multiplied the
path at each bounce that continued (S where none) and the sky colour that
ended the path (zero where it was absorbed or cut at the depth limit).
"""

from __future__ import annotations

import math
import struct

import torch

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
_MASK = 0xFFFFFFFF
_STREAM_RAY = 0x9E3779B9
_STREAM_BOUNCE = 0x85EBCA77
_STREAM_SLOT = 0xC2B2AE3D
_C2 = tuple(float.fromhex(h) for h in (
    "0x1.0000000000000p+0", "-0x1.3bd3ae0000000p+0", "0x1.03bd860000000p-2",
    "-0x1.5501920000000p-6", "0x1.c29b900000000p-11"))
_S2 = tuple(float.fromhex(h) for h in (
    "0x1.921fb40000000p+0", "-0x1.4abbb80000000p-1", "0x1.4667b20000000p-4",
    "-0x1.3238580000000p-8", "0x1.3c93ea0000000p-13"))
# Draw slots per (ray, bounce).
JITTER, LENS, BALL, GLASS = 0, 2, 8, 13
_BIG = 3.0e38


def f32(x: float) -> float:
    return struct.unpack("f", struct.pack("f", x))[0]


def sqrt(x):
    """Correctly rounded square root in x's precision (NaN below 0): CUDA's
    is; on the CPU torch's vectorised float32 root is not, so it is taken
    in float64 and rounded."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


# --- RNG lattice --------------------------------------------------------------

def _u32(x):
    return torch.as_tensor(x).to(torch.int64) & _MASK


def _mul32(a, c: int):
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _MASK


def _pcg(x):
    state = (_u32(x) * 747796405 + 2891336453) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _MASK
    return (word >> 22) ^ word


def hash_bits(seed, ray_id, bounce, slot):
    h = _pcg((_u32(seed) + _mul32(_u32(ray_id), _STREAM_RAY)) & _MASK)
    return _pcg((h + _mul32(_u32(bounce), _STREAM_BOUNCE)
                 + _mul32(_u32(slot), _STREAM_SLOT)) & _MASK)


def uniform01(seed, ray_id, bounce, slot, dtype):
    bits = hash_bits(seed, ray_id, bounce, slot)
    return (bits & 0xFFFFFF).to(dtype) * (1.0 / 16777216.0)


def uniform_pair16(seed, ray_id, bounce, slot, dtype):
    bits = hash_bits(seed, ray_id, bounce, slot)
    return ((bits & 0xFFFF).to(dtype) * (1.0 / 65536.0),
            (bits >> 16).to(dtype) * (1.0 / 65536.0))


def sincos2pi(t):
    x = t * 4.0
    q = torch.floor(x)
    f = x - q
    f2 = f * f
    c = _C2[0] + f2 * (_C2[1] + f2 * (_C2[2] + f2 * (_C2[3] + f2 * _C2[4])))
    s = f * (_S2[0] + f2 * (_S2[1] + f2 * (_S2[2] + f2 * (_S2[3] + f2 * _S2[4]))))
    q1, q2, q3 = q == 1.0, q == 2.0, q == 3.0
    sin = torch.where(q1, c, torch.where(q2, -s, torch.where(q3, -c, s)))
    cos = torch.where(q1, -s, torch.where(q2, -c, torch.where(q3, s, c)))
    return sin, cos


def in_unit_ball(seed, ray_id, bounce, dtype):
    u, v = uniform_pair16(seed, ray_id, bounce, BALL, dtype)
    bits = hash_bits(seed, ray_id, bounce, BALL + 1)
    w = torch.maximum(torch.maximum(bits & 0x3FF, (bits >> 10) & 0x3FF),
                      (bits >> 20) & 0x3FF)
    r = w.to(dtype) * (1.0 / 1024.0)
    z = 2.0 * u - 1.0
    s = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    sp, cp = sincos2pi(v)
    return r * s * cp, r * s * sp, r * z


# --- vector helpers -----------------------------------------------------------

def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def normalize3(x, y, z):
    inv = 1.0 / sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-12))
    return x * inv, y * inv, z * inv


# --- scene and camera ---------------------------------------------------------

def camera(spec: dict, aspect: float, device, dtype):
    """The thin-lens basis (rayweek1.cpp:366-379) in Python doubles,
    rounded to float32 once, then to dtype."""
    theta = spec["vfov"] * math.pi / 180.0
    half_h = math.tan(theta / 2.0)
    half_w = aspect * half_h
    o = spec["lookfrom"]

    def unit(a):
        inv = 1.0 / math.sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2])
        return tuple(x * inv for x in a)

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    w = unit(tuple(a - b for a, b in zip(o, spec["lookat"])))
    u = unit(cross(spec["vup"], w))
    v = cross(w, u)
    fd = spec["focus_dist"]
    ll = tuple(o[i] - half_w * fd * u[i] - half_h * fd * v[i] - fd * w[i]
               for i in range(3))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device).to(dtype)
    return dict(origin=t(o), lower_left=t(ll),
                horizontal=t(tuple(2.0 * half_w * fd * x for x in u)),
                vertical=t(tuple(2.0 * half_h * fd * x for x in v)),
                u=t(u), v=t(v), lens_radius=t(spec["aperture"] / 2.0))


def table(cols: dict, device, dtype):
    """The sphere table as the kernels read it: {name: tensor[S]}."""
    g = {k: torch.as_tensor(v).to(device) for k, v in cols.items()}
    real = g["radius"] != 0.0
    mt = g["mat_type"].to(torch.int64)
    q = lambda a: torch.round(torch.clamp(a, 0.0, 1.0) * 255.0) * f32(1 / 255)
    word = mt.to(torch.float32) * 32.0 + torch.where(mt == DIELECTRIC,
                                                     g["ref_idx"], g["fuzz"])
    param = word - torch.floor(word * (1.0 / 32.0)) * 32.0
    r = g["radius"]
    out = dict(cx=g["center_x"], cy=g["center_y"], cz=g["center_z"],
               rsq=torch.where(real, r * r, -1e30),
               ivr=torch.where(real, 1.0 / torch.where(real, r, 1.0), 0.0),
               ar=q(g["albedo_x"]), ag=q(g["albedo_y"]), ab=q(g["albedo_z"]),
               fuzz=param, ref_idx=torch.where(mt == DIELECTRIC, param, 1.0))
    out = {k: v.to(dtype) for k, v in out.items()}
    out["mt"] = mt
    return out


# --- the integrator -----------------------------------------------------------

def primary_rays(cam, width, height, spp, seed, ray_id, dtype):
    pixel = ray_id // spp
    x = (pixel % width).to(dtype)
    y = (pixel // width).to(dtype)
    ju, jv = uniform_pair16(seed, ray_id, -1, JITTER, dtype)
    s = (x + ju) * (1.0 / width)
    t = (y + jv) * (1.0 / height)
    u, v = uniform_pair16(seed, ray_id, -1, LENS, dtype)
    r = sqrt(u)
    st, ct = sincos2pi(v)
    rdx, rdy = r * ct * cam["lens_radius"], r * st * cam["lens_radius"]
    o, ll, h, vv = cam["origin"], cam["lower_left"], cam["horizontal"], \
        cam["vertical"]
    ox = o[0] + cam["u"][0] * rdx + cam["v"][0] * rdy
    oy = o[1] + cam["u"][1] * rdx + cam["v"][1] * rdy
    oz = o[2] + cam["u"][2] * rdx + cam["v"][2] * rdy
    dx = ll[0] + s * h[0] + t * vv[0] - ox
    dy = ll[1] + s * h[1] + t * vv[1] - oy
    dz = ll[2] + s * h[2] + t * vv[2] - oz
    inv = 1.0 / sqrt(dx * dx + dy * dy + dz * dz)
    return ox, oy, oz, dx * inv, dy * inv, dz * inv


def closest_hit(tab, ox, oy, oz, dx, dy, dz, t_min):
    """(row int64[N], t[N], hit bool[N]): the first row with the smallest
    root above t_min."""
    cox = tab["cx"] - ox[:, None]
    coy = tab["cy"] - oy[:, None]
    coz = tab["cz"] - oz[:, None]
    nb = cox * dx[:, None] + coy * dy[:, None] + coz * dz[:, None]
    c = cox * cox + coy * coy + coz * coz - tab["rsq"]
    sq = sqrt(nb * nb - c)
    t1, t2 = nb - sq, nb + sq
    t = torch.where(t1 > t_min, t1, t2)
    t = torch.where(t > t_min, t, float("inf"))
    bt, best = torch.min(t, dim=1)
    return best, bt, bt < _BIG


def scatter(tab, row, dx, dy, dz, px, py, pz, seed, ray_id, bounce, dtype):
    """((sx, sy, sz), ok): the scattered direction and whether the path
    goes on (a metal absorbs a ray that leaves through its surface)."""
    ivr = tab["ivr"][row]
    nx = (px - tab["cx"][row]) * ivr
    ny = (py - tab["cy"][row]) * ivr
    nz = (pz - tab["cz"][row]) * ivr
    mt, fuzz, ri = tab["mt"][row], tab["fuzz"][row], tab["ref_idx"][row]
    bx, by, bz = in_unit_ball(seed, ray_id, bounce, dtype)
    lx, ly, lz = normalize3(nx + bx, ny + by, nz + bz)
    d2 = 2.0 * dot3(dx, dy, dz, nx, ny, nz)
    rx, ry, rz = dx - d2 * nx, dy - d2 * ny, dz - d2 * nz
    mx, my, mz = normalize3(rx + fuzz * bx, ry + fuzz * by, rz + fuzz * bz)
    metal_ok = dot3(mx, my, mz, nx, ny, nz) > 0.0
    dn = dot3(dx, dy, dz, nx, ny, nz)
    out = dn > 0.0
    onx, ony, onz = (torch.where(out, -n, n) for n in (nx, ny, nz))
    eta = torch.where(out, ri, 1.0 / ri)
    cosine = torch.where(out, ri * dn, -dn)
    dt = dot3(dx, dy, dz, onx, ony, onz)
    disc = 1.0 - eta * eta * (1.0 - dt * dt)
    rd = sqrt(torch.clamp_min(disc, 1e-12))
    fx, fy, fz = normalize3(eta * (dx - onx * dt) - onx * rd,
                            eta * (dy - ony * dt) - ony * rd,
                            eta * (dz - onz * dt) - onz * rd)
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    oc = 1.0 - cosine
    oc2 = oc * oc
    p = torch.where(disc > 0.0, r0 + (1.0 - r0) * oc2 * oc2 * oc, 1.0)
    refl = uniform01(seed, ray_id, bounce, GLASS, dtype) < p
    gx, gy, gz = (torch.where(refl, a, b) for a, b in
                  ((rx, fx), (ry, fy), (rz, fz)))
    metal, glass = mt == METAL, mt == DIELECTRIC
    s = tuple(torch.where(glass, g, torch.where(metal, m, l)) for g, m, l in
              ((gx, mx, lx), (gy, my, ly), (gz, mz, lz)))
    return s, metal_ok | ~metal


def trace_rays(tab, cam, ray_id, width, height, spp, seed, max_bounces,
               t_min=1e-3, dtype=torch.float32, record=False,
               chunk=1 << 17):
    """Trace the given primary rays (int64[N] global ids, id = pixel * spp +
    sample) to the end. Returns (radiance dtype[N, 3], count int32[N]) and,
    with record, (rows int64[max_bounces + 1, N], sky float32[N, 3])."""
    t_min = f32(t_min)
    n = ray_id.shape[0]
    dev = ray_id.device
    rad = torch.zeros(n, 3, dtype=dtype, device=dev)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    s_rows = tab["cx"].shape[0]
    rows = (torch.full((max_bounces + 1, n), s_rows, dtype=torch.int64,
                       device=dev) if record else None)
    sky_out = torch.zeros(n, 3, dtype=dtype, device=dev) if record else None
    for lo in range(0, n, chunk):
        idx = torch.arange(lo, min(lo + chunk, n), device=dev)
        rid = ray_id[idx]
        ox, oy, oz, dx, dy, dz = primary_rays(cam, width, height, spp, seed,
                                              rid, dtype)
        att = torch.ones(idx.shape[0], 3, dtype=dtype, device=dev)
        for bounce in range(max_bounces + 1):
            if idx.numel() == 0:
                break
            count[idx] += 1
            row, bt, hit = closest_hit(tab, ox, oy, oz, dx, dy, dz, t_min)
            t = torch.where(hit, bt, 1.0)
            miss = ~hit
            ty = 0.5 * (dy + 1.0)
            sk = 1.0 - ty
            sky = torch.stack([sk + ty * 0.5, sk + ty * 0.7, sk + ty * 1.0], 1)
            rad[idx[miss]] = att[miss] * sky[miss]
            if record:
                sky_out[idx[miss]] = sky[miss]
            px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
            (sx, sy, sz), ok = scatter(tab, row, dx, dy, dz, px, py, pz, seed,
                                       rid, bounce, dtype)
            go = hit & ok & (bounce < max_bounces)
            alb = torch.stack([tab["ar"][row], tab["ag"][row],
                               tab["ab"][row]], 1)
            if record:
                rows[bounce, idx[go]] = row[go]
            att = (att * alb)[go]
            idx, rid = idx[go], rid[go]
            ox, oy, oz, dx, dy, dz = (a[go] for a in (px, py, pz, sx, sy, sz))
    if record:
        return rad, count, rows, sky_out
    return rad, count


def render_pixels(cols, cam_spec, pixels, width, height, spp, seed,
                  max_bounces, device, dtype=torch.float32, respawn=False):
    """Mean radiance (float32[P, 3]) and ray count (int64[P]) of the given
    pixel ids, every sample traced. respawn=True sums the samples in sample
    order and multiplies by float32(1 / spp), as the respawn engine does;
    otherwise the image is the mean over samples, as the one-shot engine's
    assembly takes it."""
    tab = table(cols, device, dtype)
    cam = camera(cam_spec, width / height, device, dtype)
    pix = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    ray_id = (pix[:, None] * spp + torch.arange(spp, device=device)).reshape(-1)
    rad, count = trace_rays(tab, cam, ray_id, width, height, spp, seed,
                            max_bounces, dtype=dtype)
    rad = rad.reshape(-1, spp, 3)
    if respawn:
        acc = torch.zeros_like(rad[:, 0])
        for s in range(spp):
            acc = acc + rad[:, s]
        img = acc * (1.0 / spp)
    else:
        img = rad.mean(dim=1)
    return img.float(), count.reshape(-1, spp).sum(dim=1, dtype=torch.int64)


def count_rays(cols, cam_spec, ray_ids, width, height, spp, seed,
               max_bounces, device, dtype=torch.float32) -> int:
    """The rays that the given primary rays (int64 ids, pixel * spp +
    sample) trace to the end, counted per radiance evaluation."""
    tab = table(cols, device, dtype)
    cam = camera(cam_spec, width / height, device, dtype)
    ids = torch.as_tensor(ray_ids, dtype=torch.int64, device=device)
    _, count = trace_rays(tab, cam, ids, width, height, spp, seed,
                          max_bounces, dtype=dtype)
    return int(count.sum(dtype=torch.int64))
