"""The pair-MLP kernels' roofline: the least time the card could take for
the pairs that the traced window handed to K3 (``sdf_agg_kernel``) and K2
(``value_agg_kernel``), over those kernels' device time in the trace.

Operations are counted on the real pairs only (the dump pairs that pad a
point's k slots are work a kernel may skip): K3 runs the up sweep and the
down sweep (822,784 FLOP a pair), K2 the up sweep (411,648).  Bytes count
each input read once and each output written once: the pair table, the
indices and the queries; K3's per-point sums, per-pair weights and bf16
latent gradients, K2's per-point sums.  A launch's bound is the larger of
its operations over the bf16 peak and its bytes over the memory bandwidth.
"""

from benchmark.flops import peak_tflops, prior_down_flops, prior_up_flops

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
KERNELS = {"k3": "sdf_agg_kernel", "k2": "value_agg_kernel"}


def launch_bound_s(key: str, real: int, p: int, k: int, n: int,
                   peak_flops: float) -> float:
    up, down = prior_up_flops(), prior_down_flops()
    ops = real * (up + down if key == "k3" else up)
    nbytes = (n + 1) * 35 * 4 + p * k * 4 + p * 3 * 4
    nbytes += (p * 5 * 4 + p * k * 4 + p * k * 32 * 2 if key == "k3"
               else p * 2 * 4)
    return max(ops / peak_flops, nbytes / HBM_BYTES_PER_S)


def roofline_pct(run) -> float | None:
    """The share in percent, or None where the window ran neither kernel."""
    tr = run.trace
    launches = run.counters.get("pair_launches")
    if tr is None or not launches:
        return None
    peak = peak_tflops(run.device_kind) * 1e12
    bound = sum(launch_bound_s(key, *l, peak)
                for key, ls in launches.items() for l in ls)
    dev_s = sum(v for name, v in tr["by_name"].items()
                if any(kn in name for kn in KERNELS.values()))
    if dev_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev_s
