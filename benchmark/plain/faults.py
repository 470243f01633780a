"""Faults that the benchmark's correctness check must catch, planted in
the reference put in the program's place (``benchmark.control`` and the
tests only; a benchmark run never sets them): ``half_batch`` drops the
second half of a training batch's rays before the losses, whose means are
then taken over the rest; ``sdf_offset`` adds a constant to every pair's
prior SDF where the pair MLP produces it."""

FAULTS = {"half_batch": False, "sdf_offset": 0.0}


def set_faults(half_batch: bool = False, sdf_offset: float = 0.0):
    FAULTS["half_batch"] = bool(half_batch)
    FAULTS["sdf_offset"] = float(sdf_offset)
