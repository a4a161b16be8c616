"""The window's host-clock seconds over the fit steps completed in it, each
step followed by its loss read to the host."""
UNIT = "ms"
LAYER = "end to end"


def read(result, root):
    if "steps" not in result:
        return None
    return result["window_s"] / result["steps"] * 1e3
