"""Kernels and their plain versions (K1 ``select_knn``, K2/K3 ``pair_mlp``),
the voxel-grid query, and host-side point-cloud ops."""
