"""The share of the traced window in which no operation ran on the card
(1 - busy / window), for the CLI frame, one in flight."""
UNIT = "%"
LAYER = "device"
MOVES = "mrays_per_s.cli"


def read(result, root):
    t = result.get("trace")
    if not t or "frames" not in result:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
