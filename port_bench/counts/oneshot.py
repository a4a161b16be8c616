"""Frozen count of the one-shot kernel's work on one launch: every given
primary ray traced to the end, a lane taking the next ray when its ray
ends.

Bytes: the (7, S) sphere table, six ray planes and the ray ids in; three
radiance planes and a count out, and with the topology (the fit's forward)
max_bounces + 1 int32 planes of hit rows. Operations: a sweep of every real
sphere per traced ray at SWEEP_OPS float32 adds and multiplies (see
respawn.py); shading and the RNG are not counted. A change that tests fewer
spheres per ray would read above 100%; the count is then a benchmark
change.
"""

SWEEP_OPS = 16


def work(primary: int, rows: int, real: int, rays: int, max_bounces: int,
         topology: bool) -> tuple:
    """(bytes, operations) of one launch over `primary` rays."""
    planes = 7 + 4 + (max_bounces + 1 if topology else 0)
    return 4 * (7 * rows + primary * planes), rays * real * SWEEP_OPS
