"""Vector math in planar form: a vector field is three same-shaped float32
tensors (x, y, z). Counterpart of rays1bench_tpu/core/vecmath.py.

normalize3 takes IEEE `1 / sqrt` where the JAX package has `lax.rsqrt`.
XLA:CPU's rsqrt is not correctly rounded (it matches the exactly rounded
reciprocal square root on ~85% of inputs, worst case 1 ulp), and XLA rewrites
`1/sqrt` into it, so the two packages agree here within 2 ulp, not bit for
bit. The CUDA kernels compute `1.0f / sqrtf(x)` without FMA contraction,
which is exactly what this module computes.

Every square root of the port goes through `sqrt` below: torch's vectorized
CPU sqrt is not correctly rounded (it misses on ~0.5% of float32 inputs on
an AVX-512 host), while IEEE sqrt is what XLA, numpy and CUDA's sqrtf give.
"""

from __future__ import annotations

import math
import struct

import torch


def sqrt(x):
    """Correctly rounded float32 square root (NaN for negative inputs): the
    float64 root of a float32, rounded back to float32, is exact."""
    return torch.sqrt(x.double()).float()


def dot3(ax, ay, az, bx, by, bz):
    """Elementwise dot product of two planar vector fields (mymath.h:212)."""
    return ax * bx + ay * by + az * bz


def sq_length3(x, y, z):
    return x * x + y * y + z * z


def normalize3(x, y, z, eps=1e-12):
    """Unit vector (mymath.h:215), with the squared length clamped to eps.

    clamp_min propagates NaN, as jnp.maximum does."""
    inv = 1.0 / sqrt(torch.clamp_min(sq_length3(x, y, z), eps))
    return x * inv, y * inv, z * inv


def reflect3(vx, vy, vz, nx, ny, nz):
    """Mirror reflection v - 2*dot(v,n)*n (rayweek1.cpp:414-417)."""
    d2 = 2.0 * dot3(vx, vy, vz, nx, ny, nz)
    return vx - d2 * nx, vy - d2 * ny, vz - d2 * nz


def safe_sqrt(x, eps=1e-12):
    """sqrt clamped at a strictly positive floor."""
    return sqrt(torch.clamp_min(x, eps))


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = (1.0 / (1.0 + torch.exp(-x.double()))).float()
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (y * (1.0 - y))


def sigmoid(x):
    """1 / (1 + exp(-x)) taken in float64 and rounded to float32: the CUDA
    kernels' `r1b::sigmoid` does the same double operations, so the two
    agree bit for bit on the card. jax.nn.sigmoid, torch.sigmoid and a
    float32 expf are three other roundings. The derivative is
    g * (y * (1 - y)) in float32, as lax.logistic's: autograd through the
    float64 ops would give 0 * inf = NaN where exp(-x) overflows (a miss
    lane's far row, masked but still differentiated)."""
    return _Sigmoid.apply(x)


def f32(x: float) -> float:
    """The float32 nearest to x, as a Python float: a constant that a float32
    tensor op then uses exactly, as a kernel argument of type float is."""
    return struct.unpack("f", struct.pack("f", x))[0]


# --- host-side scalar 3-vectors (camera setup) ------------------------------

def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vnorm(a):
    return vscale(a, 1.0 / math.sqrt(vdot(a, a)))
