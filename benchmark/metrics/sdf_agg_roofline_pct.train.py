"""K3's and K2's least time on the real pairs of the traced window over
their device time, in percent (``benchmark/roofline.py``), in the train
cells."""

from benchmark.roofline import roofline_pct


def read(run):
    return roofline_pct(run) if run.kind == "train" else None
