"""Weights and scenes carried across from the JAX package."""
