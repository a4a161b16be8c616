"""mrays_per_s of the CLI frame's cells, one frame in flight: a metric of
its own, as the host's issue after each sync spreads it wider."""
UNIT = "mrays/s"
LAYER = "end to end"


def read(result, root):
    from port_bench import harness
    return harness.load_module("metrics", "mrays_per_s", root).read(
        result, root)
