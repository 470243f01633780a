"""Microbenchmarks of the port's kernels, each the counterpart of a script
under the repo's ``scripts/``."""
