"""The process group and fault-tolerant re-rendering
(rays1bench_tpu/parallel/multihost.py).

* `init()` wraps torch.distributed.init_process_group (a no-op for one
  process): a dead rank fails a collective, which fails the run.
* `render_with_retry` renders shards with a retry per shard: the RNG is
  stateless in ray ids, so any subset of rays can be rendered again on any
  device and merged bit for bit, and a failed shard is simply rendered
  again, locally, without restarting the job.
* `render_image_with_retry` renders a whole image so, its shards through
  render.pipeline.trace_rays (the slice trace), equal to render_image bit
  for bit.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         backend: Optional[str] = None) -> None:
    """Start the default process group (a no-op for one process).

    coordinator_address: "host:port" of rank 0's store, or an init_method
    URL ("tcp://host:port", "file:///path/to/store"). backend: "nccl" when
    torch sees a CUDA device, else "gloo". Under NCCL each process takes the
    card of its local rank (process_id modulo the cards of the host)."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url, rank=process_id,
                            world_size=num_processes)


def render_with_retry(render_shard: Callable, ray_id_shards: Sequence,
                      max_retries: int = 2) -> Tuple[torch.Tensor, int]:
    """Render shards with per-shard retry; returns (concatenated radiance,
    number of retried shards).

    `render_shard(ids) -> radiance` may raise on device failure;
    statelessness makes the retry produce bit-identical results."""
    out = []
    retried = 0
    for ids in ray_id_shards:
        for attempt in range(max_retries + 1):
            try:
                out.append(torch.as_tensor(render_shard(ids)))
                break
            except Exception:
                if attempt == max_retries:
                    raise
                retried += 1
    return torch.cat(out), retried


def render_image_with_retry(spheres_soa, camera, cfg, num_shards: int = 4,
                            max_retries: int = 2, _render_shard=None):
    """Fault-tolerant full-image render: the ray stream is split into
    `num_shards` equal slices (padded to whole 1,024 rays; ids past the
    frame are never traced), each traced as its own call
    (render.pipeline.trace_rays) through render_with_retry and merged.
    Because the RNG is stateless in the global ray id, a retried shard is
    bit-identical to a never-failed one, and the image equals
    render_image()'s bit for bit.

    `_render_shard` is a test hook wrapping the per-shard render (e.g. to
    inject transient failures). Returns (image, num_rays, retried_shards)."""
    from rays1bench_tpu_torch.render.pipeline import trace_rays
    from rays1bench_tpu_torch.scene.spheres import prepare

    n = cfg.num_primary_rays
    per = -(-n // num_shards)
    per = -(-per // 1024) * 1024
    spheres = prepare(spheres_soa)
    device = spheres_soa.center_x.device

    def shard_fn(ids):
        return trace_rays(spheres, camera, ids, cfg)

    counts = {}  # shard's first ray id -> count (idempotent across retries)

    def render_shard(ids):
        fn = _render_shard(shard_fn) if _render_shard else shard_fn
        rad, cnt = fn(ids)
        counts[int(ids[0])] = int(cnt)
        return rad

    all_ids = torch.arange(per * num_shards, dtype=torch.int32,
                           device=device).reshape(num_shards, per)
    rad, retried = render_with_retry(render_shard, list(all_ids),
                                     max_retries=max_retries)
    image = rad[:n].reshape(cfg.height, cfg.width, cfg.spp, 3).mean(dim=2)
    return image, sum(counts.values()), retried
