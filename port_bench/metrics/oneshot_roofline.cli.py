"""The one-shot kernel's share of its roofline over the traced window of
the render (counts/oneshot.py's frozen work, without topology)."""
from port_bench import harness, roofline

UNIT = "%"
LAYER = "one-shot kernel"
MOVES = "mrays_per_s.cli"


def read(result, root):
    s = result["shape"]
    if "frame_rays" not in result:
        return None
    work = harness.load_module("counts", "oneshot", root).work(
        s["pixels"] * s["spp"], s["rows"], s["real"], result["frame_rays"],
        s["max_bounces"], topology=False)
    return roofline.share(result, "oneshot_kernel", work, root)
