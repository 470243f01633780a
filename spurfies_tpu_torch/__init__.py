"""spurfies_tpu_torch: the PyTorch/CUDA port of spurfies_tpu.

Same layout as the JAX package (config, core, ops, model, data, train,
convert), plus ``csrc/`` with the hand-written CUDA kernels for Hopper.
Every entry point takes an explicit ``device`` ("cuda" by default); on a
CUDA tensor a kernel wrapper launches its kernel, on a CPU tensor it runs
the kernel's plain PyTorch version.  The package imports neither JAX nor
anything of ``spurfies_tpu``.
"""
