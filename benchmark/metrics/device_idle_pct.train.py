"""The share of the measured window in which no operation ran on the
device, in percent, in the train cells: the traced window's busy seconds
a step over the measured window's seconds a step
(:func:`benchmark.trace.idle_pct`)."""

from benchmark.trace import idle_pct


def read(run):
    return idle_pct(run) if run.kind == "train" else None
