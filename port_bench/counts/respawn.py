"""Frozen count of the respawn engine's work on one frame: every sample of
every pixel traced to the end in one kernel, thread per pixel.

Bytes: the (7, S) float32 sphere table and the 19-float camera in; three
radiance sums and a ray count per pixel out. Operations: a sweep of every
real sphere per traced ray at SWEEP_OPS float32 adds and multiplies a
sphere test (9 FADD and 7 FMUL on the sweep's miss path in the sm_90a SASS
of the program's kernel when this count was frozen; chip_smoke.py's
SWEEP_OPS). Shading, raygen and the RNG are not counted. This is the work
these inputs need with a sweep of the whole table: a change that tests
fewer spheres per ray (a BVH, culling) does less than this count and would
read above 100%; the count is then a benchmark change.
"""

SWEEP_OPS = 16


def work(pixels: int, rows: int, real: int, rays: int) -> tuple:
    """(bytes, operations) of one frame of `pixels` pixels over a table of
    `rows` rows of which `real` are spheres, tracing `rays` rays."""
    return 4 * (7 * rows + 19 + 4 * pixels), rays * real * SWEEP_OPS
