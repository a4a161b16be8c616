"""The fused backward kernel's (kernel B's) share of its roofline over the
traced window of the fit, with the rays a step that the program counted
(counts/mega_backward.py's frozen work)."""
from port_bench import harness, roofline

UNIT = "%"
LAYER = "fused backward kernel"
MOVES = "mrays_per_s"


def read(result, root):
    s = result.get("shape")
    if not s or "step_rays" not in result:
        return None
    work = harness.load_module("counts", "mega_backward", root).work(
        s["pixels"] * s["spp"], s["rows"], result["step_rays"],
        s["max_bounces"])
    return roofline.share(result, "backward_kernel", work, root)
