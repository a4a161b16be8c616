"""The share of rank 0's traced window in which no operation but a
collective ran on its card (1 - busy less NCCL's events / window): NCCL's
kernels spin on the card while rank 0 waits for the busiest rank, so with
them its wait would read as busy."""
UNIT = "%"
LAYER = "device"
MOVES = "mrays_per_s.x4"


def read(result, root):
    t = result.get("trace")
    if not t or "frames" not in result:
        return None
    return 100.0 * (1.0 - t["compute_s"] / t["rank0_window_s"])
