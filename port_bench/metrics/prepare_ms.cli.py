"""The scene's preparation: the program's "prepare" span's stream ms (the
Morton sort, trim and packing; utils/profiling), summed over the traced
frames and divided by them. None where the program records no spans."""
UNIT = "ms"
LAYER = "scene prepare and pack"
MOVES = "mrays_per_s.cli"


def read(result, root):
    from rays1bench_tpu_torch.utils import profiling
    frame_ms = getattr(profiling, "frame_ms", None)
    return None if frame_ms is None else frame_ms("prepare", stream=True)
