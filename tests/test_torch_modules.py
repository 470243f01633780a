"""The port's modules without kernels against the JAX package's, on the
same numpy inputs: networks, encoding, density, quadrature, cameras,
metrics, pair compaction, the sampler and the colour field."""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spurfies_tpu.config import ModelConfig, SamplerConfig
from spurfies_tpu.core import cameras as jcam
from spurfies_tpu.core import density as jden
from spurfies_tpu.core import embedder as jemb
from spurfies_tpu.core import metrics as jmet
from spurfies_tpu.core import quadrature as jquad
from spurfies_tpu.model import field as jfield
from spurfies_tpu.model import networks as jnet
from spurfies_tpu.model import sampler as jsamp
from spurfies_tpu_torch.config import ModelConfig as TModelConfig
from spurfies_tpu_torch.convert.from_jax import params_from_numpy
from spurfies_tpu_torch.core import cameras as tcam
from spurfies_tpu_torch.core import density as tden
from spurfies_tpu_torch.core import embedder as temb
from spurfies_tpu_torch.core import metrics as tmet
from spurfies_tpu_torch.core import quadrature as tquad
from spurfies_tpu_torch.model import field as tfield
from spurfies_tpu_torch.model import networks as tnet
from spurfies_tpu_torch.model import sampler as tsamp


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    p = _np(jnet.init_model_params(jax.random.PRNGKey(0), ModelConfig()))
    return p, params_from_numpy(p, device="cpu")


def test_init_model_params_shapes_and_bounds(params):
    g = torch.Generator().manual_seed(0)
    t = tnet.init_model_params(TModelConfig(), g, device="cpu")
    j = params[0]
    for group in ("frozen", "train"):
        for name, layers in j[group].items():
            if name == "beta":
                assert float(t[group][name]) == float(layers)
                continue
            for lt, lj in zip(t[group][name], layers):
                for key in ("w", "b"):
                    assert tuple(lt[key].shape) == lj[key].shape
                    bound = 1.0 / np.sqrt(lj["w"].shape[0])
                    assert float(lt[key].abs().max()) <= bound


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_apply_matches_jax(params, dtype):
    """f32: same products, summed in another order (1e-5).  bf16: the
    product's output rounded to bf16 and the bias and LeakyReLU in bf16 on
    both sides; a sum that lands on a rounding boundary moves one bf16 ulp
    (2**-8) -- 99% of the entries within 2 ulps of the output scale."""
    p_np, p_t = params
    x = np.random.default_rng(0).normal(size=(512, 103)).astype(np.float32)
    jd, td = (None, None) if dtype == "f32" else (jnp.bfloat16,
                                                    torch.bfloat16)
    for final in (None, "sigmoid", "leaky_relu"):
        ref = np.asarray(jnet.mlp_apply(
            jax.tree_util.tree_map(jnp.asarray, p_np["train"]["F_color"]),
            jnp.asarray(x), final_act=final, compute_dtype=jd))
        got = tnet.mlp_apply(p_t["train"]["F_color"], torch.from_numpy(x),
                             final_act=final, compute_dtype=td).numpy()
        assert got.dtype == np.float32
        if dtype == "f32":
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        else:
            d = np.abs(got - ref)
            assert (d > 2 * 2.0 ** -8 * np.abs(ref).max()).mean() <= 0.01


def test_positional_encoding_and_density():
    x = np.random.default_rng(1).normal(size=(64, 8, 3)).astype(np.float32)
    for multires in (0, 3, 6):
        np.testing.assert_allclose(
            temb.positional_encoding(torch.from_numpy(x), multires).numpy(),
            np.asarray(jemb.positional_encoding(jnp.asarray(x), multires)),
            rtol=1e-6, atol=1e-6)
    assert temb.encoding_dim(6) == jemb.encoding_dim(6) == 39
    sdf = np.random.default_rng(2).normal(0, 0.1, (32, 40)).astype(
        np.float32)
    beta = np.float32(0.02)
    np.testing.assert_allclose(
        tden.laplace_density(torch.from_numpy(sdf), beta).numpy(),
        np.asarray(jden.laplace_density(jnp.asarray(sdf), beta)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(tden.get_beta(torch.tensor(-0.1))),
        float(jden.get_beta(jnp.asarray(-0.1))), rtol=1e-7)


def test_render_weights_and_psnr():
    rng = np.random.default_rng(3)
    deltas = rng.uniform(0, 0.05, (16, 80)).astype(np.float32)
    dens = rng.uniform(0, 50, (16, 80)).astype(np.float32)
    np.testing.assert_allclose(
        tquad.render_weights(torch.from_numpy(deltas),
                             torch.from_numpy(dens)).numpy(),
        np.asarray(jquad.render_weights(jnp.asarray(deltas),
                                        jnp.asarray(dens))),
        rtol=1e-5, atol=1e-6)
    a, b = rng.uniform(size=(2, 100, 3)).astype(np.float32)
    m = (rng.uniform(size=(100, 1)) > 0.5).astype(np.float32)
    for mask in (None, m):
        tm = None if mask is None else torch.from_numpy(mask)
        jm = None if mask is None else jnp.asarray(mask)
        np.testing.assert_allclose(
            float(tmet.psnr(torch.from_numpy(a), torch.from_numpy(b), tm)),
            float(jmet.psnr(jnp.asarray(a), jnp.asarray(b), jm)), rtol=1e-5)


def test_get_camera_params():
    rng = np.random.default_rng(4)
    uv = rng.uniform(0, 64, (1, 200, 2)).astype(np.float32)
    from spurfies_tpu_torch.data.synthetic import look_at
    pose = look_at([1.2, 0.4, 0.9])[None]
    K = np.eye(4, dtype=np.float32)[None]
    K[0, 0, 0], K[0, 1, 1], K[0, 0, 2], K[0, 1, 2], K[0, 0, 1] = \
        70.0, 72.0, 32.0, 24.0, 0.5
    dt, ct = tcam.get_camera_params(*map(torch.from_numpy, (uv, pose, K)))
    dj, cj = jcam.get_camera_params(*map(jnp.asarray, (uv, pose, K)))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("budget", [128, 512, 4096])
def test_compact_pair_slots(budget):
    valid = np.random.default_rng(5).uniform(size=3000) > 0.7
    sj, okj, ovj = jfield.compact_pair_slots(jnp.asarray(valid), budget)
    st, okt, ovt = tfield.compact_pair_slots(torch.from_numpy(valid), budget)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert bool(ovt) == bool(ovj)


def test_sample_pdf_matches_jax():
    """The searchsorted bracket against the JAX masked-reduce bracket,
    including flat (zero-mass) pdf stretches and u == 1."""
    rng = np.random.default_rng(6)
    bins = np.sort(rng.uniform(0.5, 4.5, (64, 97)), -1).astype(np.float32)
    pdf = rng.uniform(size=(64, 96)).astype(np.float32)
    pdf[:, 10:40] = 0.0
    pdf[:8] = 0.0
    pdf[:8, 50] = 1.0
    got = tsamp.sample_pdf(torch.from_numpy(bins), torch.from_numpy(pdf), 128,
                           deterministic=True).numpy()
    ref = np.asarray(jsamp.sample_pdf(None, jnp.asarray(bins),
                                      jnp.asarray(pdf), 128,
                                      deterministic=True))
    # the JAX linspace differs from a correctly rounded one by an ulp
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_error_bound_z_vals_given_the_same_probe():
    """The sampler with one analytic SDF (a sphere, probed exactly alike on
    both sides) and the eval knobs: 99% of the z-values within 1e-4."""
    cfg = SamplerConfig(n_samples_eval=32, n_samples=32, n_samples_extra=16,
                        max_total_iters=3)
    rng = np.random.default_rng(7)
    cam = np.tile(np.array([[0.0, 0.0, -2.4]], np.float32), (64, 1))
    d = rng.normal(size=(64, 3)) * [0.15, 0.15, 1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)

    def jprobe(x, first=False):
        return jnp.linalg.norm(x, axis=-1) - 0.8, jnp.asarray(False)

    def tprobe(x, first=False):
        return torch.linalg.norm(x, dim=-1) - 0.8, torch.tensor(False)

    zj, _ = jax.jit(lambda c, r: jsamp.error_bound_z_vals(
        jax.random.PRNGKey(0), jprobe, c, r, cfg, jnp.asarray(0.02), 3,
        False))(jnp.asarray(cam), jnp.asarray(d))
    zt, _ = tsamp.error_bound_z_vals(tprobe, torch.from_numpy(cam),
                                     torch.from_numpy(d), cfg,
                                     torch.tensor(0.02), 3, False)
    assert tuple(zt.shape) == zj.shape == (64, 32 + 16 + 2)
    # the JAX linspace is an ulp off a correctly rounded one, and the beta
    # bisection's discrete steps can carry that to a few samples
    d = np.abs(zt.numpy() - np.asarray(zj))
    assert (d > 1e-4).mean() <= 0.01
    assert d.max() <= 5e-3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_aggregate_color_matches_jax(params, dtype):
    """f32: 1e-5.  bf16 (the default): both sides round at the same points;
    99% of the colours within 2 bf16 ulps of 1."""
    p_np, p_t = params
    rng = np.random.default_rng(8)
    m, k = 128, 8
    n = m * k
    lat = rng.normal(0, 0.3, (n, 64)).astype(np.float32)
    # neighbours around each query at the radius's scale (see
    # test_torch_pair_mlp.py: far ones would give denormal weights)
    x = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    idx = rng.permutation(n).reshape(m, k).astype(np.int32)
    pts = np.empty((n, 3), np.float32)
    pts[idx.reshape(-1)] = np.repeat(x, k, 0) + rng.normal(0, 0.03, (n, 3))
    valid = rng.uniform(size=(m, k)) > 0.3
    dirs = rng.normal(size=(m, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jd, td = (None, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                           torch.bfloat16)
    tp_j = jax.tree_util.tree_map(jnp.asarray, p_np["train"])
    ref = np.asarray(jfield.aggregate_color(
        tp_j, jnp.asarray(lat), jnp.asarray(pts), jnp.asarray(idx),
        jnp.asarray(valid), jnp.asarray(x), jnp.asarray(dirs), 45.0,
        compute_dtype=jd))
    got = tfield.aggregate_color(
        p_t["train"], torch.from_numpy(lat), torch.from_numpy(pts),
        torch.from_numpy(idx), torch.from_numpy(valid), torch.from_numpy(x),
        torch.from_numpy(dirs), 45.0, compute_dtype=td).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(got - ref) > 2 * 2.0 ** -8).mean() <= 0.01
