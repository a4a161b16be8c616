"""The share of the respawn kernel's lane-trips that trace a ray: 100 x
the traced frames' rays over 32 x their warps' loop trips, from the
program's counters "rays" and "warp_trips" (utils/profiling). None where
the program keeps no such counters."""
UNIT = "%"
LAYER = "respawn kernel"
MOVES = "mrays_per_s"
WARP_LANES = 32


def read(result, root):
    from rays1bench_tpu_torch.utils import profiling
    total = getattr(profiling, "total", None)
    if total is None:
        return None
    rays, trips = total("rays"), total("warp_trips")
    if not rays or not trips:
        return None
    return 100.0 * rays / (WARP_LANES * trips)
