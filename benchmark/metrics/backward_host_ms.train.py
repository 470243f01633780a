"""Host milliseconds a step spends in the autograd backward
(``trainer.backward``), inclusive, over the traced window, from the
program's recorder (``spurfies_tpu_torch.utils.profiling``); moves
``train_rays_per_s``.  None where the program records no such span."""

from spurfies_tpu_torch.utils import profiling

SPANS = ("trainer.backward",)


def read(run):
    host_ms = getattr(profiling, "host_ms", None)
    if run.kind != "train" or run.trace is None or host_ms is None:
        return None
    total = host_ms(SPANS)
    return total / run.trace["units"] if total else None
