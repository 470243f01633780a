"""The real pairs among the pair slots handed to K3 and K2 (``idx_ext`` entries
in ``[0, N)`` over ``P x k``) over the traced window, in percent, from the
program's counter in ``ops/pair_mlp``; moves ``train_rays_per_s``.  None
where the program has no such counter."""

from spurfies_tpu_torch.utils import profiling


def read(run):
    pct = getattr(profiling, "real_pair_pct", None)
    if run.kind != "train" or run.trace is None or pct is None:
        return None
    return pct()
