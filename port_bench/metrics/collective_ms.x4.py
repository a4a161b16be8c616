"""The busiest rank's (most warp trips) stream ms from reaching the frame's
all_reduce to the end of its all_gather, the median over the traced frames
whose times reached rank 0 on the telemetry gather
(parallel/shard.busiest_collective_ms). None where the program keeps no
such times."""
UNIT = "ms"
LAYER = "collectives"
MOVES = "mrays_per_s.x4"


def read(result, root):
    from rays1bench_tpu_torch.parallel import shard
    busiest = getattr(shard, "busiest_collective_ms", None)
    return None if busiest is None else busiest()
