"""Rays the window traced (per radiance evaluation, summed in int64) over
its host-clock seconds, in millions: the headline's cells (the CLI's
and the four cards' read the same under names of their own)."""
UNIT = "mrays/s"
LAYER = "end to end"


def read(result, root):
    if "rays" not in result:
        return None
    return result["rays"] / result["window_s"] / 1e6
