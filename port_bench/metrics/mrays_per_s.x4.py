"""mrays_per_s of the four-card cells: a metric of its own, as four
processes on one host spread it wider."""
UNIT = "mrays/s"
LAYER = "end to end"


def read(result, root):
    from port_bench import harness
    return harness.load_module("metrics", "mrays_per_s", root).read(
        result, root)
