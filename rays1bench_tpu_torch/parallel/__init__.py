"""Sharded rendering and gradients over torch.distributed
(rays1bench_tpu/parallel/): device meshes (mesh.py), the process group and
retried renders (multihost.py), the sharded renders (shard.py) and the
multi-rank dry run on gloo CPU ranks (dryrun.py). The sharded fused
gradient is grad/mega.render_image_mega_sharded."""
