"""The yardstick's operation counts and peaks: a frozen copy of the port's
``utils/flops.py`` (``train_step_flops``, ``peak_tflops``) and the per-pair
cost of the prior's pair MLP.

"Model FLOPs" in the MFU convention: the useful matmul work of the
pipeline's MLPs (pair-SDF forward and input gradient, the sampler's probe,
the trainable colour MLPs forward and backward), not gathers, scatters or
quadrature.  ``mfu.train`` evaluates :func:`train_step_flops` at the dense
budgets (``ray_budget_frac=0``, ``probe_budget_frac=1``: every ray of the
batch, every probe point), so that no budget the program calibrates
changes the count.
"""

# dense bf16 peak TFLOP/s by card (NVIDIA's data sheets); key: a substring
# of ``torch.cuda.get_device_name``, lower case
BF16_PEAK_TFLOPS = {"h100": 989.0}
DEFAULT_PEAK_TFLOPS = 989.0

HID = 256


def peak_tflops(device_kind: str) -> float:
    dk = device_kind.lower()
    for key, val in BF16_PEAK_TFLOPS.items():
        if key in dk:
            return val
    return DEFAULT_PEAK_TFLOPS


def encoding_dim(multires: int, input_dims: int = 3) -> int:
    """Positional encoding width: the input and a sine and cosine per band."""
    return input_dims + 2 * multires * input_dims


def mlp_flops(dims) -> int:
    """2 * fan_in * fan_out per row through consecutive Linear layers."""
    return sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def prior_up_flops(d_geo: int = 32) -> int:
    """One pair through the prior's up sweep (35->256x4->1, the fused
    tail): 411,648 at the published widths."""
    return mlp_flops([d_geo + 3, HID, HID, HID, HID, 1])


def prior_down_flops(d_geo: int = 32) -> int:
    """One pair through the down sweep (the input gradient): 411,136."""
    return mlp_flops([HID, HID, HID, HID, d_geo + 3])


def train_step_flops(model: dict, train: dict, n_rays: int | None = None
                     ) -> int:
    """Model FLOPs of one training step.  ``model``/``train``: the
    configuration's ``model`` and ``train`` sections (a missing key takes
    the port's default)."""
    n_rays = n_rays or train.get("num_pixels", 1024)
    K = model.get("k", 8)
    S = model.get("max_shading_pts", 80)
    samp = model.get("ray_sampler", {})
    n_eval = samp.get("n_samples_eval", 128)
    rbf_frac = model.get("ray_budget_frac", -1.0)
    if 0 < rbf_frac < 1:
        rk = min(n_rays, max(128, -(-int(n_rays * rbf_frac) // 64) * 64))
    else:
        rk = n_rays
    fdim = model.get("feature_vector_size", 64)
    d_geo = fdim // 2
    up = prior_up_flops(d_geo)
    down = prior_down_flops(d_geo)

    mp = rk * n_eval
    pf = model.get("probe_budget_frac", -1.0)
    if 0 < pf < 1:
        bp = max(int(mp * pf) // 128 * 128, 128)
    elif pf >= 1:
        bp = mp
    else:
        bp = max(int(mp * 0.25) // 128 * 128, 128)
    bp = min(bp, mp)
    n_probes = max(1, train.get("fast_iters", 1))
    probe_fl = n_probes * bp * (model.get("probe_k", 0) or K) * up

    geo_fl = rk * S * K * (up + down)

    top = model.get("color_top_samples", 32)
    w_top = top if 0 < top < S else S
    mc = rk * w_top
    fc_in = fdim + encoding_dim(model.get("pos_multires", 6), 3)
    r_in = HID + encoding_dim(model.get("view_multires", 3), 3)
    color_fl = 3 * (mc * K * mlp_flops([fc_in, HID, HID, HID, HID])
                    + mc * mlp_flops([r_in, HID, HID, 3]))
    return int(probe_fl + geo_fl + color_fl)


def dense_train_step_flops(model: dict, train: dict) -> int:
    """:func:`train_step_flops` at the dense budgets."""
    return train_step_flops(dict(model, ray_budget_frac=0.0,
                                 probe_budget_frac=1.0), train)
