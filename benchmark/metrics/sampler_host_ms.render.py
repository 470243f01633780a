"""Host milliseconds an image spends in the error-bounded sampler's rounds
(``sampler.z_vals``), inclusive, over the traced window, from the program's
recorder (``spurfies_tpu_torch.utils.profiling``); moves
``render_rays_per_s``.  None where the program records no such span."""

from spurfies_tpu_torch.utils import profiling

SPANS = ("sampler.z_vals",)


def read(run):
    host_ms = getattr(profiling, "host_ms", None)
    if run.kind != "render" or run.trace is None or host_ms is None:
        return None
    total = host_ms(SPANS)
    return total / run.trace["units"] if total else None
