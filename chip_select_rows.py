#!/usr/bin/env python3
"""The entangled model's latent gather on the card, two ways in turns.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_select_rows.py

``model.field.entangled_sdf_feat`` gathers the neighbours' latents with
``field.select_rows`` (``index_select``, whose backward is an
``index_add_``).  This script runs ``chip_smoke.entangled_phase`` (a full
render, a batch against K1's plain version, 20 + 50 training steps, a
profile) with ``select_rows`` as it is and with plain indexing
(``table[idx]``, whose backward is a sorted ``index_put_``), in the order
indexing, select, select, indexing, and prints each run's ms/step beside
the ``nvidia-smi`` name and power limit.  It exits non-zero if a phase
fails.
"""

import os
import subprocess
import sys


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_select_rows: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from spurfies_tpu_torch.config import Config
    from spurfies_tpu_torch.data.synthetic import make_dust3r_like_scene
    from spurfies_tpu_torch.model import field
    from spurfies_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cuda_build.build()
    pts, cols, views = make_dust3r_like_scene()
    view = {"uv": views["uv"], "pose": views["pose"][0],
            "intrinsics": views["intrinsics"][0]}
    variants = {"select_rows": field.select_rows,
                "indexing": lambda table, idx: table[idx]}
    try:
        for name in ("indexing", "select_rows", "select_rows", "indexing"):
            field.select_rows = variants[name]
            cs.log(f"=== entangled latent gather: {name} [{smi}]")
            cs.entangled_phase(smi, Config(), pts, cols, views, view)
    finally:
        field.select_rows = variants["select_rows"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
