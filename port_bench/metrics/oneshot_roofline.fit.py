"""The one-shot kernel in topology mode (kernel A of the fit): its share of
its roofline over the traced window, with the rays per step the
reference traced (counts/oneshot.py's frozen work, with topology)."""
from port_bench import harness, roofline

UNIT = "%"
LAYER = "one-shot kernel"
MOVES = "step_ms"


def read(result, root):
    s = result["shape"]
    if "step_rays" not in result:
        return None
    work = harness.load_module("counts", "oneshot", root).work(
        s["pixels"] * s["spp"], s["rows"], s["real"], result["step_rays"],
        s["max_bounces"], topology=True)
    return roofline.share(result, "oneshot_kernel", work, root)
