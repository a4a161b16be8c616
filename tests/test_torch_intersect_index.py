"""Parity of the port's closest-hit index sweep (rays1bench_tpu_torch.kernels.
intersect_index) with the JAX package's Pallas kernel
(rays1bench_tpu/kernels/intersect_pallas.closest_hit_index) on the CPU.

The plain version runs the Pallas kernel's exact form on IEEE float32, and
the JAX kernel runs in interpret mode, eagerly traced into XLA:CPU but with
no multiply-add to contract before the comparisons that pick the winner, so
idx and hit are held bit-exact: on the small and medium scenes (128 rows
with placeholders), a 512-row slice of the giant scene, an awkward N = 777
and zero directions. render/intersect.closest_hit_index (valid mask,
t_max) must name the same winner wherever the ray hits and agree on which
rays hit. So must megakernel.sweep, which lets misses fall through as NaN,
on every ray but an exact tangent: where a root's discriminant rounds to
exactly 0, sqrt(0) is a root there and not in the `disc > 0` forms, as in
the JAX package's own megakernel sweep (megakernel._make_intersect). One
ray in 2,048 of the giant slice's test set is such a tangent.

The CUDA kernel itself runs only on a GPU: see tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rays1bench_tpu.kernels import intersect_pallas as jip
from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu.scene import spheres as jspheres
from rays1bench_tpu_torch.kernels import intersect_index, megakernel
from rays1bench_tpu_torch.render import intersect as tintersect
from rays1bench_tpu_torch.scene import convert
from rays1bench_tpu_torch.scene import spheres as tspheres
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS

torch.set_num_threads(1)

T_MIN = 1e-3


def rays_np(seed, n, prep):
    """n rays from a seed: origins in a box above the ground; every other
    ray aimed near a random row's center, the rest in random directions;
    every 37th direction zero."""
    r = np.random.default_rng(seed)
    o = (r.random((3, n)) * 2 - 1) * 6.0
    o[1] = np.abs(o[1]) + 0.2
    d = r.standard_normal((3, n))
    c = np.stack([prep.center_x.numpy(), prep.center_y.numpy(),
                  prep.center_z.numpy()])[:, r.integers(0, prep.count, n)]
    aim = c + r.standard_normal((3, n)) * 0.3 - o
    d[:, ::2] = aim[:, ::2]
    d /= np.linalg.norm(d, axis=0)
    d[:, ::37] = 0.0
    return [x.astype(np.float32) for x in (*o, *d)]


def scene_preps(name, rows=None):
    """(JAX PreparedSpheres, port PreparedSpheres) of the same leaves, cut
    to the first `rows` rows."""
    jsoa = jbuilders.SCENES[name](16 / 9).spheres
    leaves = {c: np.asarray(getattr(jsoa, c))[:rows] for c in COLUMNS}
    jsoa = dataclasses.replace(jsoa, **{c: jnp.asarray(v)
                                        for c, v in leaves.items()})
    return (jspheres.prepare(jsoa),
            tspheres.prepare(convert.soa_from_numpy(leaves, "cpu")))


CASES = [("small", None, 777), ("medium", None, 4096),
         ("giant", 512, 2048)]


@pytest.mark.parametrize("name,rows,n", CASES)
def test_reference_matches_the_pallas_kernel(name, rows, n):
    jprep, prep = scene_preps(name, rows)
    rays = rays_np(n, n, prep)
    want_idx, want_hit = jip.closest_hit_index(
        jprep, *map(jnp.asarray, rays), T_MIN, 2048, True)
    idx, hit = intersect_index.closest_hit_index_reference(
        intersect_index.pack(prep), *map(torch.from_numpy, rays), T_MIN)
    assert idx.dtype == torch.int32 and hit.dtype == torch.bool
    assert np.array_equal(idx.numpy(), np.asarray(want_idx))
    assert np.array_equal(hit.numpy(), np.asarray(want_hit))
    assert 0.02 < hit.float().mean() < 0.98
    assert not hit[::37].all()   # zero directions hit only from inside


@pytest.mark.parametrize("name,rows,n", CASES)
def test_the_three_sweeps_pick_the_same_winner(name, rows, n):
    _, prep = scene_preps(name, rows)
    rays = [torch.from_numpy(r) for r in rays_np(n + 1, n, prep)]
    idx, hit = intersect_index.closest_hit_index_reference(
        intersect_index.pack(prep), *rays, T_MIN)
    best2, hit2 = tintersect.closest_hit_index(*rays, prep, T_MIN, 3.4e38)
    assert torch.equal(hit, hit2)
    assert torch.equal(idx[hit].long(), best2[hit])
    best, bt = megakernel.sweep(megakernel.pack_spheres(prep), *rays, T_MIN)
    ox, oy, oz, dx, dy, dz = rays
    cox = prep.center_x[best] - ox
    coy = prep.center_y[best] - oy
    coz = prep.center_z[best] - oz
    nb = cox * dx + coy * dy + coz * dz
    c = cox * cox + coy * coy + coz * coz - prep.radius_sq[best]
    tangent = (bt < 3e38) & (nb * nb - c == 0.0)
    assert int(tangent.sum()) <= 1
    keep = ~tangent
    assert torch.equal(hit[keep], (bt < 3e38)[keep])
    assert torch.equal(idx[hit & keep].long(), best[hit & keep])
    # A miss names row 0, as the Pallas kernel's initial index does.
    assert (idx[~hit] == 0).all()


def test_wrapper_on_cpu_runs_the_plain_version_and_checks_inputs():
    _, prep = scene_preps("medium")
    rays = [torch.from_numpy(r) for r in rays_np(5, 500, prep)]
    before = intersect_index.LAUNCHES
    idx, hit = intersect_index.closest_hit_index(prep, *rays, T_MIN)
    assert intersect_index.LAUNCHES == before
    ref = intersect_index.closest_hit_index_reference(
        intersect_index.pack(prep), *rays, T_MIN)
    assert torch.equal(idx, ref[0]) and torch.equal(hit, ref[1])
    with pytest.raises(ValueError):
        intersect_index.closest_hit_index(prep, *rays[:5], rays[5][:-1],
                                          T_MIN)
    with pytest.raises(ValueError):
        intersect_index.closest_hit_index(prep, *rays[:5], rays[5].double(),
                                          T_MIN)


def test_index_carries_no_gradient():
    """The index is constant under differentiation, as the JAX custom_vjp
    declares: outputs need no grad even when the inputs do."""
    _, prep = scene_preps("small")
    rays = [torch.from_numpy(r).requires_grad_(True)
            for r in rays_np(6, 300, prep)]
    cx = prep.center_x.clone().requires_grad_(True)
    prep = dataclasses.replace(prep, center_x=cx)
    idx, hit = intersect_index.closest_hit_index(prep, *rays, T_MIN)
    assert not idx.requires_grad and not hit.requires_grad
    assert not intersect_index.pack(prep).requires_grad
