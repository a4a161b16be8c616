"""Device time per frame of everything but the program's kernels: raygen
and the spp mean in plain torch, and the table's preparation."""
from port_bench import roofline

UNIT = "ms"
LAYER = "plain torch around the kernels"
MOVES = "mrays_per_s.cli"


def read(result, root):
    s = roofline.torch_ops_s(result)
    if s is None or "frames" not in result:
        return None
    return s / result["trace"]["units"] * 1e3
