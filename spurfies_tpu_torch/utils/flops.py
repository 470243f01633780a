"""Analytic per-step model-FLOP count for the train step, for a
model-FLOP utilisation figure (port of ``spurfies_tpu/utils/flops.py``: the
same count, the same integer for the same config).

"Model FLOPs" in the MFU convention: the useful matmul work of the
pipeline's MLPs (pair-SDF fwd+input-grad, probe value sweep, trainable
color fwd+bwd), NOT bandwidth ops (gathers/scatters/quadrature).  The
counts mirror the kernels:

  * geometry pair MLP (K3, ``csrc/sdf_agg.cu``): up sweep 35->256,
    3x 256->256, fused 256->1; down sweep back -- run on every
    [kept_rays * S, K] pair (reference hot loop
    pointneus_disent.py:300-323 and its double backprop).
  * sampler probe (K2, the value kernel): up sweep only, on the probe
    budget.
  * color MLPs (model/field.aggregate_color): F_color 103->256->256->
    256->256 per pair, R 277->256->256->3 per point; trainable, so
    fwd+bwd ~= 3x fwd (dX + dW each cost one fwd-equivalent).

:func:`peak_tflops` is the denominator: the card's dense bf16 peak.
"""

from spurfies_tpu_torch.core.embedder import encoding_dim

# dense bf16 peak TFLOP/s by card (public data sheets); key = a substring
# of ``torch.cuda.get_device_name``, lower case
BF16_PEAK_TFLOPS = {
    "h100": 989.0,      # H100 SXM
}
DEFAULT_PEAK_TFLOPS = 989.0


def peak_tflops(device_kind: str) -> float:
    dk = device_kind.lower()
    for key, val in BF16_PEAK_TFLOPS.items():
        if key in dk:
            return val
    return DEFAULT_PEAK_TFLOPS


def _mlp_flops(dims) -> int:
    """2*fan_in*fan_out per row through consecutive Linear layers."""
    return sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def train_step_flops(cfg, n_rays: int | None = None) -> int:
    """Model FLOPs of ONE train step under ``cfg`` (post-calibration:
    pass the Trainer's cfg so the auto budgets are resolved numbers)."""
    m = cfg.model
    n_rays = n_rays or cfg.train.num_pixels
    K = m.k
    S = m.max_shading_pts
    samp = m.ray_sampler

    # ray budget (renderer.render: 64-row alignment)
    if 0 < m.ray_budget_frac < 1:
        rk = min(n_rays, max(128, -(-int(n_rays * m.ray_budget_frac)
                                    // 64) * 64))
    else:
        rk = n_rays

    d_geo = m.feature_vector_size // 2
    up = _mlp_flops([d_geo + 3, 256, 256, 256, 256, 1])     # fused tail
    down = _mlp_flops([256, 256, 256, 256, d_geo + 3])      # transposed

    # sampler probe: value kernel on the (first-probe) budget; train
    # fast_iters=1 means exactly one probe per step
    mp = rk * samp.n_samples_eval
    pf = m.probe_budget_frac
    if 0 < pf < 1:
        bp = max(int(mp * pf) // 128 * 128, 128)
    elif pf >= 1:
        bp = mp
    else:
        bp = max(int(mp * 0.25) // 128 * 128, 128)
    bp = min(bp, mp)
    n_probes = max(1, cfg.train.fast_iters)
    probe_fl = n_probes * bp * (m.probe_k or K) * up

    # render-path pair MLP: value + input gradient on every pair
    geo_fl = rk * S * K * (up + down)

    # color: top-W samples (0 = all S), fwd + bwd (trainable)
    w_top = m.color_top_samples if 0 < m.color_top_samples < S else S
    mc = rk * w_top
    fc_in = m.feature_vector_size + encoding_dim(m.pos_multires, 3)
    r_in = 256 + encoding_dim(m.view_multires, 3)
    color_fl = 3 * (mc * K * _mlp_flops([fc_in, 256, 256, 256, 256])
                    + mc * _mlp_flops([r_in, 256, 256, 3]))

    return int(probe_fl + geo_fl + color_fl)
