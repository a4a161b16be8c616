"""Device meshes over the process group (rays1bench_tpu/parallel/mesh.py).

The JAX package's mesh is a jax.sharding.Mesh over the devices of one SPMD
program. The port's is a torch.distributed DeviceMesh over the ranks of the
default process group, one rank per device: NCCL on CUDA, gloo on the CPU
(parallel/multihost.init starts the group; the mesh does not). A rank's
coordinate in the mesh says which rays it traces (parallel/shard.py); the
scene and camera are replicated, every rank holding its own copy.

Axis convention, as in the JAX package: "rays" for a 1-D mesh over primary
rays, ("tiles", "samples") for the 2-D mesh whose first axis splits pixels
and second the samples of each pixel. The stateless RNG keys on global ray
ids, so no factorization of the ranks changes any ray.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from rays1bench_tpu_torch.core.device import resolve


def _mesh(shape, names, device) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one with "
                           "parallel.multihost.init (or torchrun) first")
    n = 1
    for k in shape:
        n *= k
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks over a group of "
                         f"{dist.get_world_size()}: the mesh spans the group")
    return init_device_mesh(resolve(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "rays",
              device="cuda") -> DeviceMesh:
    """A 1-D mesh over the group's ranks (default: all; n_devices must be
    the group's size). device: "cuda" (NCCL) or "cpu" (gloo)."""
    n = dist.get_world_size() if n_devices is None and \
        dist.is_initialized() else n_devices
    return _mesh((n,), (axis_name,), device)


def make_submesh(n_devices: int, axis_name: str = "rays",
                 device="cuda") -> Optional[DeviceMesh]:
    """A 1-D mesh over the group's first n_devices ranks, on a subgroup of
    its own (dist.new_group, which every rank of the group must call, in
    the same order); None on the ranks outside it. The sharded renders
    (parallel/shard.render_image_sharded, render_image_pallas_sharded and
    grad/mega.render_image_mega_sharded) run their collectives on the
    mesh's group, their gradients' all_reduce included, so the ranks
    outside it take no part: a scaling sweep's points (bench/scaling.py),
    or a fit on some of the ranks."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one with "
                           "parallel.multihost.init (or torchrun) first")
    if not 1 <= n_devices <= dist.get_world_size():
        raise ValueError(f"a mesh of {n_devices} ranks in a group of "
                         f"{dist.get_world_size()}")
    group = dist.new_group(list(range(n_devices)))
    if dist.get_rank() >= n_devices:
        return None
    return DeviceMesh.from_group(group, resolve(device).type,
                                 mesh_dim_names=(axis_name,))


def make_mesh2d(n_tiles: int, n_samples: int,
                axis_names: Sequence[str] = ("tiles", "samples"),
                device="cuda") -> DeviceMesh:
    """A (tiles, samples) 2-D mesh over the group's n_tiles * n_samples
    ranks, row-major: rank = tile * n_samples + sample. The samples axis
    needs n_samples | spp at render time."""
    return _mesh((n_tiles, n_samples), axis_names, device)


def layout(mesh: DeviceMesh, axis_name: str, sample_axis=None):
    """(n_tiles, n_samples, tile, sample): the mesh's shape along axis_name
    and sample_axis (1 without one) and this rank's coordinate. The mesh's
    axes must be exactly these."""
    names = tuple(mesh.mesh_dim_names or ())
    want = (axis_name,) + ((sample_axis,) if sample_axis else ())
    if names != want:
        raise ValueError(f"the mesh's axes are {names}, the render shards "
                         f"over {want}")
    n_tiles = mesh.size(0)
    n_samp = mesh.size(1) if sample_axis else 1
    tile = mesh.get_local_rank(axis_name)
    sample = mesh.get_local_rank(sample_axis) if sample_axis else 0
    return n_tiles, n_samp, tile, sample
