"""Synthetic scenes and the pixel grid (numpy copies of the JAX package's)."""
