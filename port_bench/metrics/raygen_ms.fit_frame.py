"""Raygen in plain torch in a fit step: the program's "raygen" span's
stream ms (ray_coords and primary_rays inside the step's forward,
kernels/pipeline.render_image_topology; utils/profiling), summed over the
traced window and divided by its steps. None where the program records no
such span."""
UNIT = "ms"
LAYER = "plain torch around the kernels"
MOVES = "mrays_per_s"


def read(result, root):
    from rays1bench_tpu_torch.utils import profiling
    t = result.get("trace")
    spans = getattr(profiling, "spans", None)
    if not t or not t.get("units") or spans is None or "steps" not in result:
        return None
    got = [s.stream_ms for s in spans("raygen") if s.end_ns is not None]
    if not got or None in got:
        return None
    return sum(got) / t["units"]
