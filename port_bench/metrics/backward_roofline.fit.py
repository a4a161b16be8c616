"""The fused backward kernel's (kernel B's) share of its roofline over the
traced window (counts/mega_backward.py's frozen work)."""
from port_bench import harness, roofline

UNIT = "%"
LAYER = "fused backward kernel"
MOVES = "step_ms"


def read(result, root):
    s = result["shape"]
    if "step_rays" not in result:
        return None
    work = harness.load_module("counts", "mega_backward", root).work(
        s["pixels"] * s["spp"], s["rows"], result["step_rays"],
        s["max_bounces"])
    return roofline.share(result, "backward_kernel", work, root)
