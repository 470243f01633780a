"""The plain reference of the benchmark's cells: a frozen copy of the plain
PyTorch paths of ``spurfies_tpu_torch`` at the default model options (the
renderer, the error-bounded sampler, the field, the prior's pair MLP, the
kNN selection, the losses, the local feature loss, the two-group Adam), in
f32 with no kernel, pruned of the options the cells do not run.  It
imports nothing of the program and takes nothing the program made; the
benchmark hands it the same inputs, and it works out the scene's tables,
neighbours and budgets again."""
