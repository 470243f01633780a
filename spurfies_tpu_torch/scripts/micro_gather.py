"""Microbenchmark of K9, the row gather from a resident point table
(counterpart of ``scripts/micro_gather.py``).

    python -m spurfies_tpu_torch.scripts.micro_gather [--rows 655360]
        [--n 6144] [--d 40]

It times PyTorch's ``table[idx]`` beside K9 (``ops/gather_rows.py``), then
K9 at each rows-per-block setting (the JAX script sweeps tile and unroll),
each held bit-equal to ``table[idx]`` first.  It runs on the card only:
the kernel has no CPU version to time.
"""

import argparse
import sys

import numpy as np
import torch

from spurfies_tpu_torch.ops import gather_rows as gr

ROWS_PER_BLOCK = (8, 16, 32, 64)


def cuda_ms(fn, iters=20):
    """Mean device time of ``fn`` (CUDA events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=655360)
    ap.add_argument("--n", type=int, default=6144)
    ap.add_argument("--d", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("micro_gather: needs a CUDA device", file=sys.stderr)
        return 2

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    table = torch.as_tensor(rng.normal(size=(args.n, args.d)),
                            dtype=torch.float32, device=dev)
    idx = torch.as_tensor(rng.integers(0, args.n, args.rows),
                          dtype=torch.int32, device=dev)
    ref = gr.gather_rows_ref(table, idx)

    ms_lib = cuda_ms(lambda: gr.gather_rows_ref(table, idx))
    print(f"torch gather     [{args.rows}, {args.d}]: {ms_lib:7.4f} ms")
    vpr = args.d // 4 if args.d % 4 == 0 else args.d
    for rpb in ROWS_PER_BLOCK:
        if rpb * vpr > 1024:
            continue
        got = gr.gather_rows(table, idx, rows_per_block=rpb)
        if not torch.equal(got, ref):
            print(f"micro_gather: rows_per_block={rpb} differs from "
                  "table[idx]", file=sys.stderr)
            return 1
        ms = cuda_ms(lambda: gr.gather_rows(table, idx, rows_per_block=rpb))
        print(f"cuda rows_per_block={rpb:3d}: {ms:7.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
