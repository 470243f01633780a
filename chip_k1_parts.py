#!/usr/bin/env python3
"""K1 packed's lane groups: ``csrc/select_knn.cu`` timed with kGroup = 2,
4 (the source's) and 8 lanes a query.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_k1_parts.py

It builds the variants into ``spurfies_tpu_torch/build/parts/`` (one
``nvcc`` each, all at once; a variant is a text edit of the source's
``kGroup``), makes the first 4096-ray chunk's K1 inputs of
view 0 of the DUSt3R-like scene as ``chip_smoke.py``'s phase 4 makes them
(the shading
query, 401,408 queries, and the first probe, 131,072), and cuts the
shading input's first 81,536, 11,520 and 1,024 queries: the sizes of a
training step's three K1 launches.  Each variant must give the plain
version's ids and d2 bit for bit on every input; each is timed on each by
its device time (``torch.profiler``, 20 launches) and by CUDA events
around 20 back-to-back launches of its C entry.  The last line is the
``nvidia-smi`` name and power limit.
"""

import ctypes
import os
import subprocess
import sys

GROUPS = (2, 4, 8)
SIZES = (81536, 11520, 1024)


def device_ms(fn, reps, kernel):
    """Mean device time of the device kernels whose name contains
    ``kernel`` over ``reps`` calls of ``fn`` (``torch.profiler``'s kernel
    durations, after one warm-up call): the card's own time, where CUDA
    events around back-to-back launches of a small kernel read the host's
    launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if kernel in e.key)
    if us <= 0:
        raise SystemExit(f"chip_k1_parts: the profiler saw no {kernel}")
    return us / reps / 1e3


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_k1_parts: needs a CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as smoke
    from spurfies_tpu_torch.config import Config
    from spurfies_tpu_torch.convert.from_jax import PRIOR_ASSET
    from spurfies_tpu_torch.data.synthetic import make_dust3r_like_scene
    from spurfies_tpu_torch.ops import cuda_build
    from spurfies_tpu_torch.ops import select_knn as sk
    from spurfies_tpu_torch.ops.pair_mlp import _prep_layers

    src = (cuda_build.CSRC_DIR / "select_knn.cu").read_text()
    base = "constexpr int kGroup = 4;"
    if base not in src:
        raise SystemExit(f"chip_k1_parts: {base!r} not found")
    out = cuda_build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for g in GROUPS:
        name = f"k1_g{g}"
        (out / f"{name}.cu").write_text(
            src.replace(base, f"constexpr int kGroup = {g};"))
        procs[g] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for g, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_k1_parts: nvcc kGroup={g} failed:\n"
                             f"{log}")
        report = [lines for entry, lines in
                  cuda_build.ptxas_report(log).items()
                  if "select_packed_kernelILi8" in entry]
        print(f"kGroup={g}: " + " | ".join(sum(report, [])), flush=True)

    dev = torch.device("cuda")
    cfg = Config()
    pts, cols, views = make_dust3r_like_scene()
    scene, tp, frozen = smoke.setup_scene(pts, cols, cfg, PRIOR_ASSET, 0, dev)
    view = {"uv": views["uv"], "pose": views["pose"][0],
            "intrinsics": views["intrinsics"][0]}
    cam, dirs, _, _ = smoke.first_chunk(scene, view, cfg, dev)
    with torch.no_grad():
        inp = smoke.kernel_inputs(scene, tp, _prep_layers(frozen), cam, dirs,
                                  cfg)
    xs, cs = inp["shade_k1"]
    shapes = {"shading": inp["shade_k1"], "probe": inp["probe_k1"]}
    for n in SIZES:
        shapes[f"shading[:{n}]"] = (xs[:n].contiguous(), cs[:n].contiguous())
    args = {name: smoke.k1_args(x, c, scene, cfg.model.k, True)
            for name, (x, c) in shapes.items()}
    refs = {name: sk.select_knn_ref(*a) for name, a in args.items()}
    stream = torch.cuda.current_stream().cuda_stream
    for g in GROUPS:
        lib = ctypes.CDLL(str(out / f"libk1_g{g}.so"))
        fn = lib.select_knn_launch
        fn.argtypes, fn.restype = sk._SIG["select_knn_launch"], ctypes.c_int
        for name, (x, cid, qidx, qpos, r2, k, _) in args.items():
            m = x.shape[0]
            oi = torch.empty((m, k), dtype=torch.int32, device=dev)
            od = torch.empty((m, k), dtype=torch.float32, device=dev)

            def run():
                cuda_build.check(fn(
                    x.data_ptr(), cid.data_ptr(), qidx.data_ptr(),
                    qpos.data_ptr(), m, qidx.shape[0], qidx.shape[1], k, r2,
                    1, oi.data_ptr(), od.data_ptr(), stream), "select_knn")

            run()
            torch.cuda.synchronize()
            ri, rd = refs[name]
            if not (torch.equal(oi, ri) and torch.equal(od, rd)):
                raise SystemExit(f"chip_k1_parts: kGroup={g} {name}: not "
                                 "the plain version's ids and d2")
            dms = device_ms(run, 20, "select_packed_kernel")
            ems = smoke.cuda_ms(run, 20)
            print(f"kGroup={g} {name} M={m}: bit-equal; device "
                  f"{dms:.4f} ms, events {ems:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
