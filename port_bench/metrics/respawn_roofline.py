"""The respawn kernel's share of its roofline over the traced window
(counts/respawn.py's frozen work of a frame)."""
from port_bench import harness, roofline

UNIT = "%"
LAYER = "respawn kernel"
MOVES = "mrays_per_s"


def read(result, root):
    s = result["shape"]
    if "frame_rays" not in result:
        return None
    work = harness.load_module("counts", "respawn", root).work(
        s["pixels"], s["rows"], s["real"], result["frame_rays"])
    return roofline.share(result, "respawn_kernel", work, root)
