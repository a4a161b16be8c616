"""Frozen count of the fused backward kernel's work on one launch (kernel B
of the "mega" fit): the fixed-topology replay of every traced bounce,
forward and reversed.

Bytes: 21 float32 rows a sphere (the (11, S) exact table in, the ten
column sums out), and per primary ray its six ray planes and id, three
cotangents and max_bounces + 1 topology planes in and six
ray cotangents out. Operations: BACKWARD_OPS float32 adds and multiplies a
live bounce, counted by hand on the cheapest hit path (lambertian) when this
count was frozen: the replay's hit record 33, scatter 59, attenuation 3;
the reverse's recompute 33, the ball again 36, normalize's adjoint 38, the
rest of the chain 70 (chip_smoke.py's BACKWARD_OPS). At these shapes bytes
bound it.
"""

BACKWARD_OPS = 270


def work(primary: int, rows: int, rays: int, max_bounces: int) -> tuple:
    """(bytes, operations) of one launch over `primary` rays that traced
    `rays` bounces in the forward."""
    return (4 * (21 * rows + primary * (10 + max_bounces + 1 + 6)),
            rays * BACKWARD_OPS)
