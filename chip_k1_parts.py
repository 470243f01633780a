#!/usr/bin/env python3
"""K1's lane groups: ``csrc/select_knn.cu`` timed with other group sizes.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_k1_parts.py

It builds the variants into ``spurfies_tpu_torch/build/parts/`` (one
``nvcc`` each, all at once; a variant is a text edit of the source's
``kPackedGroup`` or ``kExactGroup``):

  * packed, 2, 4 and 8 lanes a query, on the first 4096-ray chunk's K1
    inputs of view 0 of the DUSt3R-like scene as ``chip_smoke.py``'s phase
    4 makes them (the shading query, 401,408 queries, and the first probe,
    131,072), and on the shading input's first 81,536, 11,520 and 1,024
    queries: the sizes of a training step's three K1 launches;
  * exact, 4, 8 and 16 lanes a query, on the same chunk's inputs of the
    dense sphere (37,267 points, qcap 128) and on the three K1 launches of
    one training step on it (``chip_smoke.capture_step``).

Each variant must give the plain version's ids and d2 bit for bit on every
input; each is timed on each by its device time (``torch.profiler``, 20
launches) and by CUDA events around 20 back-to-back launches of its C
entry.  The last line is the ``nvidia-smi`` name and power limit.
"""

import ctypes
import os
import re
import subprocess
import sys

# (label, packed, the key's name, the source's constant and its value)
VARIANTS = tuple(
    [(f"packed G={g}", True, "PackedKey", ("kPackedGroup", g))
     for g in (2, 4, 8)]
    + [(f"exact G={g}", False, "ExactKey", ("kExactGroup", g))
       for g in (4, 8, 16)])
SIZES = (81536, 11520, 1024)


def device_ms(fn, reps, kernel):
    """Mean device time of the device kernels whose name contains
    ``kernel`` over ``reps`` calls of ``fn`` (``torch.profiler``'s kernel
    durations, after one warm-up call): the card's own time, where CUDA
    events around back-to-back launches of a small kernel read the host's
    launch rate.  None where the profiler saw no such kernel."""
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
    return us / reps / 1e3 if us > 0 else None


def build_variants(cuda_build):
    """Start one nvcc a variant, all at once; print each one's registers.
    Returns {label: library path}."""
    src = (cuda_build.CSRC_DIR / "select_knn.cu").read_text()
    out = cuda_build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, _, key, (const, value) in VARIANTS:
        pat = rf"constexpr int {const} = \d+;"
        if re.search(pat, src) is None:
            raise SystemExit(f"chip_k1_parts: {const} not found")
        text = re.sub(pat, f"constexpr int {const} = {value};", src)
        name = "k1_" + re.sub(r"\W+", "_", label)
        (out / f"{name}.cu").write_text(text)
        procs[label] = (subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out / f"lib{name}.so", key)
    libs = {}
    for label, (proc, path, key) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_k1_parts: nvcc {label} failed:\n{log}")
        report = [lines for entry, lines in
                  cuda_build.ptxas_report(log).items()
                  if f"{key}ELi8E" in entry]
        print(f"{label}: " + " | ".join(sum(report, [])), flush=True)
        libs[label] = path
    return libs


def chunk_inputs(smoke, scene, tp, frozen, views, cfg, dev):
    """K1's (x, cid) of the first 4096-ray chunk of view 0: shading, probe."""
    import torch

    from spurfies_tpu_torch.ops.pair_mlp import _prep_layers

    view = {"uv": views["uv"], "pose": views["pose"][0],
            "intrinsics": views["intrinsics"][0]}
    cam, dirs, _, _ = smoke.first_chunk(scene, view, cfg, dev)
    with torch.no_grad():
        inp = smoke.kernel_inputs(scene, tp, _prep_layers(frozen), cam, dirs,
                                  cfg)
    return {"shading": inp["shade_k1"], "probe": inp["probe_k1"]}


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
    from spurfies_tpu_torch.data.synthetic import (
        make_dust3r_like_scene,
        make_synthetic_scene,
    )
    from spurfies_tpu_torch.ops import cuda_build
    from spurfies_tpu_torch.ops import select_knn as sk
    from spurfies_tpu_torch.train.trainer import Trainer

    libs = build_variants(cuda_build)
    dev = torch.device("cuda")
    cfg = Config()
    k = cfg.model.k

    # packed: dust3r_like's chunk and cuts of its shading input
    pts, cols, views = make_dust3r_like_scene()
    scene, tp, frozen = smoke.setup_scene(pts, cols, cfg, PRIOR_ASSET, 0, dev)
    shapes = chunk_inputs(smoke, scene, tp, frozen, views, cfg, dev)
    xs, cs = shapes["shading"]
    for n in SIZES:
        shapes[f"shading[:{n}]"] = (xs[:n].contiguous(), cs[:n].contiguous())
    args = {"packed": {f"dust3r_like {name}":
                       smoke.k1_args(x, c, scene, k, True)
                       for name, (x, c) in shapes.items()}}

    # exact: the dense sphere's chunk and one training step's launches
    pts, cols, views = make_synthetic_scene(
        n_points=40000, n_views=3, img_res=(192, 256), radius=0.8,
        cam_dist=2.4, seed=1)
    scene, tp, frozen = smoke.setup_scene(pts, cols, cfg, PRIOR_ASSET, 1, dev)
    shapes = chunk_inputs(smoke, scene, tp, frozen, views, cfg, dev)
    args["exact"] = {f"dense_sphere {name}":
                     smoke.k1_args(x, c, scene, k, False)
                     for name, (x, c) in shapes.items()}
    trainer = Trainer(cfg, pts, cols, views, device="cuda")
    trainer.load_frozen(frozen)
    for a in smoke.capture_step(trainer)["select_knn"]:
        args["exact"][f"dense_sphere train {a[0].shape[0]}"] = a
    del trainer

    stream = torch.cuda.current_stream().cuda_stream
    refs = {name: sk.select_knn_ref(*a)
            for kind in args.values() for name, a in kind.items()}
    for label, packed, key, _ in VARIANTS:
        lib = ctypes.CDLL(str(libs[label]))
        fn = lib.select_knn_launch
        fn.argtypes = sk._SIG["select_knn_launch"]
        fn.restype = ctypes.c_int
        for name, (x, cid, qidx, qpos, r2, kk, _) in \
                args["packed" if packed else "exact"].items():
            m = x.shape[0]
            oi = torch.empty((m, kk), dtype=torch.int32, device=dev)
            od = torch.empty((m, kk), dtype=torch.float32, device=dev)

            def run():
                cuda_build.check(fn(
                    x.data_ptr(), cid.data_ptr(), qidx.data_ptr(),
                    qpos.data_ptr(), m, qidx.shape[0], qidx.shape[1], kk,
                    r2, int(packed), oi.data_ptr(), od.data_ptr(), stream),
                    "select_knn")

            run()
            torch.cuda.synchronize()
            ri, rd = refs[name]
            if not (torch.equal(oi, ri) and torch.equal(od, rd)):
                raise SystemExit(f"chip_k1_parts: {label} {name}: not the "
                                 "plain version's ids and d2")
            dms = device_ms(run, 20, key)
            ems = smoke.cuda_ms(run, 20)
            dev_s = "not measured" if dms is None else f"{dms:.4f} ms"
            print(f"{label} {name} M={m} qcap={qidx.shape[1]}: bit-equal; "
                  f"device {dev_s}, events {ems:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
