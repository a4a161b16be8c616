"""Raygen in plain torch: the program's "raygen" span's stream ms
(ray_coords and primary_rays; utils/profiling), summed over the traced
frames and divided by them. None where the program records no spans."""
UNIT = "ms"
LAYER = "raygen in torch"
MOVES = "mrays_per_s.cli"


def read(result, root):
    from rays1bench_tpu_torch.utils import profiling
    frame_ms = getattr(profiling, "frame_ms", None)
    return None if frame_ms is None else frame_ms("raygen", stream=True)
