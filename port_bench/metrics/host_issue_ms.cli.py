"""The host's issue of a frame: the program's "frame" span's host ms
(utils/profiling), summed over the traced frames and divided by them. None
where the program records no spans."""
UNIT = "ms"
LAYER = "host issue of a frame"
MOVES = "mrays_per_s.cli"


def read(result, root):
    from rays1bench_tpu_torch.utils import profiling
    frame_ms = getattr(profiling, "frame_ms", None)
    return None if frame_ms is None else frame_ms("frame", stream=False)
