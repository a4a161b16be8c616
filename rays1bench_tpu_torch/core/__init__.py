"""Config, stateless RNG and planar vector math.

The JAX package's core/cache.py (its persistent XLA compile cache) has no
counterpart here: PyTorch runs eagerly, and the CUDA kernels are cached by
kernels/build.py.
"""
