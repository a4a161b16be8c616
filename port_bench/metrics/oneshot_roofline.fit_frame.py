"""The one-shot kernel in topology mode (kernel A of the fit's forward):
its share of its roofline over the traced window, with the rays a step
that the program counted (counts/oneshot.py's frozen work, with
topology)."""
from port_bench import harness, roofline

UNIT = "%"
LAYER = "one-shot kernel"
MOVES = "mrays_per_s"


def read(result, root):
    s = result.get("shape")
    if not s or "step_rays" not in result:
        return None
    work = harness.load_module("counts", "oneshot", root).work(
        s["pixels"] * s["spp"], s["rows"], s["real"], result["step_rays"],
        s["max_bounces"], topology=True)
    return roofline.share(result, "oneshot_kernel", work, root)
