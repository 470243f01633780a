#!/usr/bin/env python3
"""Where K8b's and K8a's time goes: ``csrc/color_mlp.cu`` timed with parts
taken out.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_k8_parts.py

It builds variants of the colour kernels' source into
``spurfies_tpu_torch/build/parts/`` (one ``nvcc`` each, all at once), each
with one part of the work removed by a text edit of the source, and times
K8b (``fused_color_bwd``) on each with the same seeded input: the training
step's 26,624 points of 8 pairs, 30 % of the pair slots invalid
(``tests/test_torch_cuda._colour_inputs``).  The variants' outputs are
wrong by design; only their times mean anything.

VARIANTS below names each variant and its edits.  It prints each
variant's ptxas register and spill report, then two rounds of times (ms,
CUDA events over 10 calls of the wrapper after one warm-up; K8a's time
beside K8b's), each device kernel's time a launch on the unedited source
(``torch.profiler`` over 5 calls of each wrapper on one pack), then the
``nvidia-smi`` name and power limit.
"""

import os
import re
import subprocess
import sys

VARIANTS = {
    "base": [],
    # the split-K dW product's mma instructions removed
    "no_dw_products": [("          mma_bf16(acc[mi][ni], a[mi],",
                        "          if (0) mma_bf16(acc[mi][ni], a[mi],")],
    # neither the dW kernel nor the fixed-order sums launched
    "no_dw_pass": [("  color_dw_kernel<<<", "  if (0) color_dw_kernel<<<"),
                   ("  color_reduce_kernel<<<",
                    "  if (0) color_reduce_kernel<<<")],
    # the producer signals each stage without copying weights
    "no_weight_loads": [("  bulk_load(ring_ptr + stage * kChunk,",
                         "  mbar_arrive(ring.full + stage);\n"
                         "  if (0) bulk_load(ring_ptr + stage * kChunk,")],
    # every wgmma instruction removed
    "no_products": [("      wgmma_256(acc, wg_desc(", "      if (0) wgmma_256("
                     "acc, wg_desc("),
                    ("        wgmma_64(acc, da, db,",
                     "        if (0) wgmma_64(acc, da, db,"),
                    ("        wgmma_8(acc, da, db,",
                     "        if (0) wgmma_8(acc, da, db,")],
    # the layers' epilogues (bias, LeakyReLU, gates, column sums) removed
    "no_epilogues": [("        epi_act<true>(acc, act,",
                      "        if (0) epi_act<true>(acc, act,"),
                     ("        epi_act<false>(acc, act,",
                      "        if (0) epi_act<false>(acc, act,"),
                     ("    epi_act<true>(acc, act,",
                      "    if (0) epi_act<true>(acc, act,"),
                     ("    epi_delta<", "    if (0) epi_delta<")],
    # no layer input or delta stored to the scratch
    "no_scratch_stores": [("  for (int e = ti; e < kWgRows * w8; e += 128) {",
                           "  return;\n  for (int e = ti; e < kWgRows * w8; "
                           "e += 128) {")],
}


def main():
    import ctypes

    import torch
    if not torch.cuda.is_available():
        print("chip_k8_parts: needs a CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.join(here, "tests")]
    from spurfies_tpu_torch.ops import cuda_build
    from spurfies_tpu_torch.ops import fused_color as fc
    from test_torch_cuda import _colour_inputs

    src = (cuda_build.CSRC_DIR / "color_mlp.cu").read_text()
    out = cuda_build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"chip_k8_parts: {name}: {old!r} not found")
            text = text.replace(old, new)
        (out / f"color_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             str(out / f"libcolor_{name}.so"), str(out / f"color_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_k8_parts: nvcc {name} failed:\n{log}")
        for entry, lines in cuda_build.ptxas_report(log).items():
            print(f"{name} {entry}: " + " | ".join(lines), flush=True)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    ins, f_color, r, rgb_bar = _colour_inputs(dev, 26624)
    args = (*ins, f_color, r)
    for rnd in range(2):
        for name in VARIANTS:
            lib = ctypes.CDLL(str(out / f"libcolor_{name}.so"))
            for fn_name, sig in fc._SIG.items():
                getattr(lib, fn_name).argtypes = sig
                getattr(lib, fn_name).restype = ctypes.c_int
            lib.fused_color_bwd_scratch_bytes.restype = ctypes.c_longlong
            fc._lib = lambda lib=lib: lib
            times = {}
            for kernel, fn in (("K8a", lambda: fc.fused_color_fwd(
                    *args, torch.bfloat16)), ("K8b", lambda: fc.fused_color_bwd(
                        *args, rgb_bar, torch.bfloat16))):
                fn()
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(10):
                    fn()
                t1.record()
                torch.cuda.synchronize()
                times[kernel] = t0.elapsed_time(t1) / 10
            print(f"round {rnd} {name}: K8b {times['K8b']:.4f} ms, K8a "
                  f"{times['K8a']:.4f} ms", flush=True)
    # each device kernel's share, on the source as it is
    lib = ctypes.CDLL(str(out / "libcolor_base.so"))
    for fn_name, sig in fc._SIG.items():
        getattr(lib, fn_name).argtypes = sig
        getattr(lib, fn_name).restype = ctypes.c_int
    lib.fused_color_bwd_scratch_bytes.restype = ctypes.c_longlong
    fc._lib = lambda: lib
    packed = fc.pack_color_weights(f_color, r)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            fc.fused_color_fwd(*args, torch.bfloat16, packed=packed)
            fc.fused_color_bwd(*args, rgb_bar, torch.bfloat16, packed=packed)
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        name = re.search(r"color_\w+_kernel", evt.key)
        if name and evt.self_device_time_total > 0:
            print(f"profile {name.group(0)}: "
                  f"{evt.self_device_time_total / 1e3 / evt.count:.4f} ms a "
                  f"launch ({evt.count} launches)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
