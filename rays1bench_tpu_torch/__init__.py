"""rays1bench_tpu_torch — the PyTorch + CUDA port of rays1bench_tpu.

Same subpackages and module names as the JAX package (core, scene, render,
kernels, bench), so every module has an obvious counterpart there. This
package imports torch and numpy and never jax; the JAX package is the
reference the tests check it against.
"""
