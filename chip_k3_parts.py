#!/usr/bin/env python3
"""Where K3's time goes: ``csrc/sdf_agg.cu`` timed with parts taken out.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_k3_parts.py

It builds variants of K3's source into ``spurfies_tpu_torch/build/parts/``
(one ``nvcc`` each, all at once), each with one part of the work removed
by a text edit of the source, and times each on the same seeded input:
327,680 points of k = 8 pairs with 0..8 real pairs each
(``tests/test_torch_cuda._mixed_pairs``, the render chunk's P).  The
variants' outputs are wrong by design; only their times mean anything.

  base           the kernel as it is
  no_products    the wgmma instructions removed
  no_loads       the producer signals each stage without copying weights
  no_epilogues   the up and down sweeps' epilogues removed
  products_only  neither weight copies nor epilogues
  regs_56_224    setmaxnreg 56 / 224 in place of 40 / 232

The edits reach K2's, K6a's, K6b's and K7a's kernels in the same source too;
only K3's (``sdf_agg_kernel``) is reported and timed.  It prints each
variant's ptxas register and spill report of K3, then two rounds of
times (ms, CUDA events over 10 launches after one warm-up), then the
``nvidia-smi`` name and power limit.
"""

import ctypes
import os
import subprocess
import sys

VARIANTS = {
    "base": [],
    "no_products": [("wgmma_256(acc,", "if (0) wgmma_256(acc,"),
                    ("wgmma_40(acc,", "if (0) wgmma_40(acc,")],
    "no_loads": [("  bulk_load(sm + kSmRing",
                  "  mbar_arrive(full_w + stage);\n"
                  "  if (0) bulk_load(sm + kSmRing")],
    "no_epilogues": [("epi_up<false, kGrad>(acc,",
                      "if (0) epi_up<false, kGrad>(acc,"),
                     ("epi_up<true, kGrad>(acc,",
                      "if (0) epi_up<true, kGrad>(acc,"),
                     ("delta_init(c.gates", "if (0) delta_init(c.gates"),
                     ("epi_down(acc,", "if (0) epi_down(acc,")],
    "regs_56_224": [("u32 40;", "u32 56;"), ("u32 232;", "u32 224;")],
}
VARIANTS["products_only"] = VARIANTS["no_loads"] + VARIANTS["no_epilogues"]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_k3_parts: needs a CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.join(here, "tests")]
    from spurfies_tpu_torch.ops import cuda_build, pair_mlp
    from test_torch_cuda import _mixed_pairs

    src = (cuda_build.CSRC_DIR / "sdf_agg.cu").read_text()
    out = cuda_build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"chip_k3_parts: {name}: {old!r} not found")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_k3_parts: nvcc {name} failed:\n{log}")
        report = [lines for entry, lines in
                  cuda_build.ptxas_report(log).items()
                  if "sdf_agg_kernel" in entry]
        print(f"{name}: " + " | ".join(sum(report, [])), flush=True)

    dev = torch.device("cuda")
    table, idx, x, prior = _mixed_pairs(dev, 327680)
    p, k = idx.shape
    wbuf, bbuf = prior.k3_buffer(), prior.bias_buffer()
    pt = torch.empty((p, 5), device=dev)
    w = torch.empty(p * k, device=dev)
    r = torch.empty((p * k, 32), dtype=torch.bfloat16, device=dev)
    sig = pair_mlp._SIG_SDF_AGG["pair_sdf_aggregate_launch"]
    for rnd in range(2):
        for name in VARIANTS:
            fn = ctypes.CDLL(str(out / f"lib{name}.so")).pair_sdf_aggregate_launch
            fn.argtypes, fn.restype = sig, ctypes.c_int

            def run():
                cuda_build.check(fn(
                    table.data_ptr(), table.shape[0], idx.data_ptr(),
                    x.data_ptr(), p, k, wbuf.data_ptr(), bbuf.data_ptr(),
                    45.0 ** 2, pt.data_ptr(), w.data_ptr(), r.data_ptr(),
                    torch.cuda.current_stream().cuda_stream), name)

            run()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(10):
                run()
            t1.record()
            torch.cuda.synchronize()
            print(f"round {rnd} {name}: {t0.elapsed_time(t1) / 10:.4f} ms",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
