#!/usr/bin/env python3
"""How far K3's ``r_lat`` strays from its plain version on trained states,
and whether a LeakyReLU gate on its kink explains the largest strays.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_k3_flips.py

It trains ``chip_smoke.py`` phase 15's synthetic DTU scan through the CLI
(``configs/dtu_pn.yaml``, CLI_STEPS + CLI_RESUME_STEPS steps in one call),
then takes STEPS (100) more training steps and, in each, holds K3's
``r_lat`` on the real pairs of each launch against

  plain       ``pair_sdf_aggregate_ref``, as ``check_pair`` does;
  plain_perm  the same with the hidden units of every layer permuted: the
              same function, its f32 sums in another order.

Per launch it reads the largest ``|err| / column scale`` of the kernel and
of ``plain_perm`` against ``plain`` (``check_pair`` fails a launch above
0.05).  For the kernel's worst entry of each launch above 0.02 it prints
the pair's smallest kink margin ``|a| / sum|terms|`` over the
pre-activations of the four LeakyReLU layers, and the worst error of that
pair's row against the plain version of the row recomputed alone, as it is
and with the gate of one of its eight units nearest the kink flipped (the
best of the eight).  Then the ``nvidia-smi`` name and power limit.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

STEPS = 100


def permuted(layers):
    """``layers`` with the hidden units of each LeakyReLU layer permuted."""
    import torch

    from spurfies_tpu_torch.ops.pair_mlp import PriorLayers

    gen = torch.Generator().manual_seed(0)
    ws, bs = list(layers.ws), list(layers.bs)
    for i in range(layers.n_act):
        p = torch.randperm(ws[i].shape[1], generator=gen).to(ws[i].device)
        ws[i], bs[i], ws[i + 1] = ws[i][:, p], bs[i][:, p], ws[i + 1][p]
    return PriorLayers(ws, bs, layers.n_act, layers.compute_dtype)


def worst(out, ref):
    """The largest ``|out - ref| / column scale`` and its (row, column)."""
    scale = ref.abs().amax(0, keepdim=True) + 1e-30
    ratio = (out - ref).abs() / scale
    flat = int(ratio.argmax())
    return float(ratio.max()), divmod(flat, ratio.shape[1]), scale


def kink(table, idx_ext, x, layers, rbf, row, kernel_row, scale):
    """The pair ``row``'s smallest kink margin, and the worst error of
    ``kernel_row`` against the plain version of this one row recomputed
    (its products in another order than the batch's), as it is
    (``recomputed``) and with the gate of one of its eight nearest-kink
    units flipped (``flipped``, the best of them)."""
    import torch

    from spurfies_tpu_torch.ops import pair_mlp as pm

    g, xpi, _ = pm._gather(table, idx_ext, x, rbf)
    g, xpi = g[row:row + 1], xpi[row:row + 1]
    d = g.shape[1] - 3
    cd = layers.compute_dtype
    lat, pos = g[:, :d].to(cd).float(), xpi.to(cd).float()
    w0 = layers.ws[0].float()
    a = pm._first_split(layers, g[:, :d], xpi)
    terms = lat.abs() @ w0[:d].abs() + pos.abs() @ w0[d:].abs() \
        + layers.bs[0].abs()
    pre, margins = [], []
    for i in range(layers.n_act):
        if i > 0:
            a = pm._mm(h, layers.ws[i]) + layers.bs[i]
            terms = h.float().abs() @ layers.ws[i].float().abs() \
                + layers.bs[i].abs()
        pre.append(a)
        margins.append(a.abs() / (terms + 1e-30))
        h = torch.maximum(a, 0.01 * a).to(cd)
    m = torch.cat(margins, 1)[0]
    near = torch.argsort(m)[:8]
    gates = [p > 0 for p in pre]

    def err(gs):
        r = pm._down_sweep(layers, gs, 1, x.device)[:, :d].to(cd).float()
        return float(((kernel_row - r).abs() / scale[0]).max())

    best = None
    for j in near.tolist():
        layer, unit = divmod(j, pre[0].shape[1])
        gs = [gt.clone() for gt in gates]
        gs[layer][0, unit] = ~gs[layer][0, unit]
        e = err(gs)
        if best is None or e < best[0]:
            best = (e, layer, unit, float(m[j]))
    return {"min_margin": float(m.min()), "recomputed": err(gates),
            "flipped": best[0], "flip_layer": best[1], "flip_unit": best[2],
            "flip_margin": best[3]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_k3_flips: needs a CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from spurfies_tpu_torch.cli import train as cli_train
    from spurfies_tpu_torch.data.synthetic import export_synthetic_dtu
    from spurfies_tpu_torch.ops import cuda_build, pair_mlp

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: f32
    cuda_build.build()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        export_synthetic_dtu(data, scan_id=24, n_views=cs.CLI_VIEWS,
                             img_res=cs.CLI_RES, n_points=40000, radius=0.8,
                             cam_dist=2.4, seed=1)
        total = cs.CLI_STEPS + cs.CLI_RESUME_STEPS
        t0 = time.perf_counter()
        [(trainer, _)] = cli_train.main([
            "--config", os.path.join(here, "configs", "dtu_pn.yaml"),
            "--scans", "scan24", f"dataset.data_dir_root={data}",
            f"exps_folder={os.path.join(tmp, 'exps')}",
            f"train.opt_steps={total}", f"train.render_freq={total}",
            f"train.checkpoint_freq={total}"])
        print(f"trained {total} steps in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for step in range(STEPS):
            seen = cs.capture_step(trainer)
            for i, (table, idx_ext, x, layers, rbf) in enumerate(
                    seen["pair_sdf_aggregate"]):
                with torch.no_grad():
                    out = pair_mlp.pair_sdf_aggregate(table, idx_ext, x,
                                                      layers, rbf)[2]
                    ref = pair_mlp.pair_sdf_aggregate_ref(
                        table, idx_ext, x, layers, rbf)[2]
                    alt = pair_mlp.pair_sdf_aggregate_ref(
                        table, idx_ext, x, permuted(layers), rbf)[2]
                real = ((idx_ext >= 0) & (idx_ext < table.shape[0] - 1)
                        ).reshape(-1)
                where = real.nonzero()[:, 0]
                k_err, (r, _), scale = worst(out[real].float(),
                                             ref[real].float())
                p_err, _, _ = worst(alt[real].float(), ref[real].float())
                row = {"step": step, "launch": i, "pairs": int(real.sum()),
                       "kernel": k_err, "plain_perm": p_err}
                if k_err > 0.02:
                    with torch.no_grad():
                        row.update(kink(table, idx_ext, x, layers, rbf,
                                        int(where[r]),
                                        out[where[r]].float()[None], scale))
                rows.append(row)
                print(json.dumps(row), flush=True)
            del seen
    for key in ("kernel", "plain_perm"):
        vals = sorted(r[key] for r in rows)
        print(f"{key}: {len(vals)} launches, above 0.05: "
              f"{sum(v > 0.05 for v in vals)}, median {vals[len(vals) // 2]:.4f}, "
              f"max {vals[-1]:.4f}")
    flips = [r for r in rows if "flipped" in r]
    if flips:
        print(f"kernel worst entries above 0.02: {len(flips)}; within 0.01 "
              f"of the recomputed row with one gate flipped: "
              f"{sum(r['flipped'] < 0.01 for r in flips)}, without: "
              f"{sum(r['recomputed'] < 0.01 for r in flips)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
