"""Stateless counter-based RNG: the same lattice as rays1bench_tpu/core/rng.py.

Every draw is a pure function of integer coordinates
(seed, ray_id, bounce, draw_slot) hashed to uniform bits with the PCG-family
integer hash (Jarzynski & Olano, JCGT 2020). The path therefore needs no
torch.Generator and no RNG state of any kind: the same coordinates give the
same bits in the JAX package, in this module and in the CUDA kernels
(kernels/csrc/path_math.cuh), on any device and in any order.

torch.uint32 cannot carry the hash on the CPU (add and >> raise
NotImplementedError for UInt32), so the integer work here is done in int64
and masked back to 32 bits after every add and multiply. Products are split
so no intermediate leaves int64's range. The CUDA kernels use native
uint32_t. Float conversion and the polynomials keep the JAX package's op
order, so the draws agree bit for bit with it (run eagerly there; jitted XLA
contracts multiply-adds into FMAs).
"""

from __future__ import annotations

import torch

from rays1bench_tpu_torch.core.vecmath import sqrt

_MASK = 0xFFFFFFFF

_STREAM_RAY = 0x9E3779B9
_STREAM_BOUNCE = 0x85EBCA77
_STREAM_SLOT = 0xC2B2AE3D

_INV_2_24 = 1.0 / 16777216.0
_INV_2_16 = 1.0 / 65536.0
_INV_2_10 = 1.0 / 1024.0

# Quadrant polynomials of sincos2pi as float32 values (written as the
# doubles they round to): cos(f*pi/2) even and sin(f*pi/2) odd minimax fits
# on f in [0, 1), the JAX package's _C2 / _S2.
_C2 = (float.fromhex("0x1.0000000000000p+0"),
       float.fromhex("-0x1.3bd3ae0000000p+0"),
       float.fromhex("0x1.03bd860000000p-2"),
       float.fromhex("-0x1.5501920000000p-6"),
       float.fromhex("0x1.c29b900000000p-11"))
_S2 = (float.fromhex("0x1.921fb40000000p+0"),
       float.fromhex("-0x1.4abbb80000000p-1"),
       float.fromhex("0x1.4667b20000000p-4"),
       float.fromhex("-0x1.3238580000000p-8"),
       float.fromhex("0x1.3c93ea0000000p-13"))


def _u32(x):
    """Integer tensor or Python int -> int64 tensor holding its uint32 bits."""
    return torch.as_tensor(x).to(torch.int64) & _MASK


def _mul32(a, c: int):
    """(a * c) mod 2^32 for a uint32 value held in int64 and a constant
    c < 2^32, split in 16-bit halves so no product exceeds 2^48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg_hash(x):
    """One round of the PCG-RXS-M-XS output permutation on uint32 bits
    (held in int64)."""
    x = _u32(x)
    state = (x * 747796405 + 2891336453) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _MASK
    return (word >> 22) ^ word


def hash_bits(seed, ray_id, bounce, slot):
    """uint32 random bits (in int64) for lattice coordinates
    (seed, ray_id, bounce, slot); the arguments broadcast. The ray coordinate
    is hashed before the (bounce, slot) Weyl fold."""
    h = pcg_hash((_u32(seed) + _mul32(_u32(ray_id), _STREAM_RAY)) & _MASK)
    x = (h + _mul32(_u32(bounce), _STREAM_BOUNCE)
         + _mul32(_u32(slot), _STREAM_SLOT)) & _MASK
    return pcg_hash(x)


def bits_to_uniform01(bits):
    """bits -> float32 in [0, 1): the low 24 bits over 2^24 (mymath.h:27-30)."""
    return (bits & 0xFFFFFF).to(torch.float32) * _INV_2_24


def uniform01(seed, ray_id, bounce, slot):
    """Uniform float32 in [0, 1)."""
    return bits_to_uniform01(hash_bits(seed, ray_id, bounce, slot))


def uniform_pair16(seed, ray_id, bounce, slot):
    """Two uniforms in [0, 1) at 16-bit resolution from one hash."""
    bits = hash_bits(seed, ray_id, bounce, slot)
    u = (bits & 0xFFFF).to(torch.float32) * _INV_2_16
    v = (bits >> 16).to(torch.float32) * _INV_2_16
    return u, v


def sincos2pi(t):
    """(sin(2 pi t), cos(2 pi t)) for float32 t in [0, 1): one quadrant
    reduction and two short polynomials, in the JAX package's Horner order."""
    x = t * 4.0
    q = torch.floor(x)
    f = x - q
    f2 = f * f
    c = _C2[0] + f2 * (_C2[1] + f2 * (_C2[2] + f2 * (_C2[3] + f2 * _C2[4])))
    s = f * (_S2[0] + f2 * (_S2[1] + f2 * (_S2[2] + f2 * (_S2[3] + f2 * _S2[4]))))
    q1 = q == 1.0
    q2 = q == 2.0
    q3 = q == 3.0
    sin = torch.where(q1, c, torch.where(q2, -s, torch.where(q3, -c, s)))
    cos = torch.where(q1, -s, torch.where(q2, -c, torch.where(q3, s, c)))
    return sin, cos


def in_unit_ball(seed, ray_id, bounce, slot0=0):
    """Uniform point inside the unit ball as three component tensors:
    an isotropic direction from (z, phi) area sampling, scaled by
    max(w1, w2, w3) of three 10-bit uniforms (the r^3 CDF). Slots slot0
    (pair16) and slot0 + 1."""
    u, v = uniform_pair16(seed, ray_id, bounce, slot0)
    bits = hash_bits(seed, ray_id, bounce, slot0 + 1)
    w1 = bits & 0x3FF
    w2 = (bits >> 10) & 0x3FF
    w3 = (bits >> 20) & 0x3FF
    r = torch.maximum(torch.maximum(w1, w2), w3).to(torch.float32) * _INV_2_10
    z = 2.0 * u - 1.0
    s = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    sp, cp = sincos2pi(v)
    return r * s * cp, r * s * sp, r * z


def in_unit_disk(seed, ray_id, bounce, slot0=0):
    """Uniform point inside the unit disk (x, y), by the polar map. One hash
    (pair16) at slot0."""
    u, v = uniform_pair16(seed, ray_id, bounce, slot0)
    r = sqrt(u)
    st, ct = sincos2pi(v)
    return r * ct, r * st


def pixel_jitter(seed, ray_id):
    """Film-plane jitter (ju, jv) in [0,1)^2, one hash on the bounce == -1
    lattice row (rayweek1.cpp:757-759)."""
    return uniform_pair16(seed, ray_id, -1, Slots.PIXEL_JITTER_U)


class Slots:
    """Reserved draw slots per (ray, bounce)."""
    PIXEL_JITTER_U = 0     # primary-ray uv jitter (bounce == -1 lattice row)
    PIXEL_JITTER_V = 1
    LENS_U = 2             # thin-lens aperture sample
    LENS_V = 3
    SCATTER_BALL = 8       # lambertian/metal unit-ball sample (and slot 9)
    DIELECTRIC_P = 13      # reflect-vs-refract probability draw
    SILHOUETTE_P = 14      # soft-silhouette draw (JAX gradient path)
