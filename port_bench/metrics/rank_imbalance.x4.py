"""The busiest rank's warp loop trips over the mean rank's, from the
kernels' telemetry (render_image_pallas_sharded(..., telemetry=True)) on
the traced window's last frame."""
UNIT = "ratio"
LAYER = "sharded split"
MOVES = "mrays_per_s.x4"


def read(result, root):
    iters = result.get("rank_iters")
    if iters is None:
        return None
    iters = iters.double()
    return float(iters.max() / iters.mean())
