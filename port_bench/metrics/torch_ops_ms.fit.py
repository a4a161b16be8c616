"""Device time per fit step of everything but the program's kernels:
raygen, prepare and pack, the loss, autograd's chain and Adam."""
from port_bench import roofline

UNIT = "ms"
LAYER = "plain torch around the kernels"
MOVES = "step_ms"


def read(result, root):
    s = roofline.torch_ops_s(result)
    if s is None or "steps" not in result:
        return None
    return s / result["trace"]["units"] * 1e3
