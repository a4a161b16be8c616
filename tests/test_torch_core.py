"""Parity of rays1bench_tpu_torch.core with rays1bench_tpu.core on the CPU.

The RNG lattice must be bit-exact: every sample the port draws is the JAX
package's sample. The JAX functions run eagerly here (op by op, IEEE); under
jit, XLA:CPU contracts multiply-adds into FMAs and drifts by an ulp.
normalize3 differs only through XLA's rsqrt, which is not correctly rounded:
it is 1 ulp off the exact reciprocal root on ~12% of inputs, and one ulp of
the factor can be two of the product where the two sit at opposite ends of
their binades, plus the product's own rounding. Measured on 1M standard
normal vectors: 69% equal, 27% 1 ulp, 3.7% 2 ulp, 0.003% 3 ulp.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rays1bench_tpu.core import config as jconfig
from rays1bench_tpu.core import rng as jrng
from rays1bench_tpu.core import vecmath as jvec
from rays1bench_tpu_torch.core import config as tconfig
from rays1bench_tpu_torch.core import rng as trng
from rays1bench_tpu_torch.core import vecmath as tvec

torch.set_num_threads(1)

N = 100_000
SEED = 10001


def ulp_diff(a, b):
    """Distance in float32 units in the last place, elementwise."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def ids(seed=0):
    """N int32 ray ids: a random spread plus 0 and the int32 extremes of a
    1280x720 @ 250 spp frame."""
    r = np.random.default_rng(seed).integers(0, 230_400_000, N - 3)
    return np.concatenate([[0, 230_399_999, 2**31 - 1], r]).astype(np.int32)


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_config_fields_and_presets_match():
    assert dataclasses.asdict(tconfig.RenderConfig()) == \
        dataclasses.asdict(jconfig.RenderConfig())
    assert tconfig.PRESETS.keys() == jconfig.PRESETS.keys()
    for k in jconfig.PRESETS:
        assert dataclasses.asdict(tconfig.PRESETS[k]) == \
            dataclasses.asdict(jconfig.PRESETS[k]), k
        assert tconfig.PRESETS[k].aspect == jconfig.PRESETS[k].aspect


@pytest.mark.parametrize("field,value,mode", [
    ("pallas_intersect", True, "closest-hit index kernel"),
    ("soft_silhouette", 0.005, "soft renderer"),
])
def test_config_refuses_unported_modes(field, value, mode):
    """Both modes are ported now (the index kernel, the soft renderer): a
    config that asks for `mode` is accepted and keeps the value."""
    assert getattr(tconfig.RenderConfig(**{field: value}), field) == value
    cfg = tconfig.PRESETS["quick"].replace(**{field: value})
    assert getattr(cfg, field) == value
    assert cfg == tconfig.get_config("quick", **{field: value})
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfig.PRESETS["quick"].replace(**{field: value}))


def test_pcg_hash_bit_exact():
    x = np.random.default_rng(1).integers(0, 2**32, N, dtype=np.uint64)
    x = np.concatenate([[0, 1, 2**32 - 1], x[3:]]).astype(np.uint32)
    want = np.asarray(jrng.pcg_hash(jnp.asarray(x))).astype(np.int64)
    got = trng.pcg_hash(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bounce", [-1, 0, 7, 49])
@pytest.mark.parametrize("fn,slot", [("hash_bits", 3), ("uniform01", 13),
                                     ("uniform_pair16", 0),
                                     ("in_unit_disk", 2),
                                     ("in_unit_ball", 8)])
def test_lattice_draws_bit_exact(fn, slot, bounce):
    rid = ids(bounce + 2)
    want = getattr(jrng, fn)(jnp.uint32(SEED), jnp.asarray(rid),
                             jnp.int32(bounce), slot)
    got = getattr(trng, fn)(SEED, torch.from_numpy(rid), bounce, slot)
    if fn == "hash_bits":
        want, got = (np.asarray(want).astype(np.int64),), (got,)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        w, g = np.asarray(w), as_np(g)
        assert g.dtype == w.dtype or fn == "hash_bits"
        assert np.array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                              w.view(np.int32) if w.dtype == np.float32 else w)


def test_pixel_jitter_bit_exact():
    rid = ids(9)
    want = jrng.pixel_jitter(jnp.uint32(SEED), jnp.asarray(rid))
    got = trng.pixel_jitter(SEED, torch.from_numpy(rid))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_sincos2pi_bit_exact():
    t = np.random.default_rng(2).random(N).astype(np.float32)
    t[:8] = [0.0, 0.25, 0.5, 0.75, np.nextafter(np.float32(0.25), 0),
             np.nextafter(np.float32(1), 0), 1 / 65536, 0.999]
    want = jrng.sincos2pi(jnp.asarray(t))
    got = trng.sincos2pi(torch.from_numpy(t))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).view(np.int32),
                              g.numpy().view(np.int32))


def test_bits_to_uniform01_bit_exact():
    bits = np.random.default_rng(3).integers(0, 2**32, N, dtype=np.uint64)
    want = jrng.bits_to_uniform01(jnp.asarray(bits.astype(np.uint32)))
    got = trng.bits_to_uniform01(torch.from_numpy(bits.astype(np.int64)))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_normalize3_within_3ulp_and_nan_propagates():
    v = np.random.default_rng(4).standard_normal((3, N)).astype(np.float32)
    v[:, 0] = 0.0   # clamped at eps
    want = jvec.normalize3(*map(jnp.asarray, v))
    got = tvec.normalize3(*map(torch.from_numpy, v))
    for w, g in zip(want, got):
        assert ulp_diff(np.asarray(w), g.numpy()).max() <= 3
    nan = torch.tensor([float("nan")])
    assert torch.isnan(tvec.normalize3(nan, nan, nan)[0]).all()


def test_sqrt_correctly_rounded():
    x = np.random.default_rng(5).random(N).astype(np.float32) * 1e4
    x[:3] = [0.0, -1.0, 2.0]
    got = tvec.sqrt(torch.from_numpy(x)).numpy()
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    assert np.array_equal(got, want, equal_nan=True)
    assert np.array_equal(np.asarray(jnp.sqrt(jnp.asarray(x[3:]))), got[3:])


def test_reflect_and_dot_bit_exact():
    v = np.random.default_rng(6).standard_normal((6, N)).astype(np.float32)
    want = jvec.reflect3(*map(jnp.asarray, v))
    got = tvec.reflect3(*map(torch.from_numpy, v))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert np.array_equal(np.asarray(jvec.dot3(*map(jnp.asarray, v))),
                          tvec.dot3(*map(torch.from_numpy, v)).numpy())


def test_port_never_imports_jax():
    """Importing every module of the port (and chip_smoke.py), the gradient
    slice's included, leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rays1bench_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "assert len(names) >= 26, names\n"
        "for n in ('grad.mega', 'grad.inverse', 'grad.checkpoint', "
        "'kernels.mega_backward', 'bench.grad'):\n"
        "    assert 'rays1bench_tpu_torch.' + n in names, n\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'rays1bench_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
