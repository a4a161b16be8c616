"""The lookfrom half of the JAX camera-fit recipe on the port's "mega"
engine (the fused kernels' plain versions on the CPU), held to the JAX
bars per fit over the 25 starts of tests/test_torch_camera_recipe.py, which
says why; more than half must meet both (measured: 16 of 25). A file of its
own, so that the two engines' sweeps run on separate test workers.
"""

import torch

from test_torch_camera_recipe import lookfrom_from_most_starts

torch.set_num_threads(1)


def test_lookfrom_recipe_meets_the_jax_bars_from_most_starts_on_mega():
    lookfrom_from_most_starts("mega")
