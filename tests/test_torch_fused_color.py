"""K8a / K8b plain versions, ``FusedColor`` and the fused branch of
``aggregate_color`` against the JAX package's fused colour kernels
(``spurfies_tpu/ops/pallas_color.py``), run as its own tests run them on
the CPU (interpret mode, ``tests/test_pallas_mlp.py:182-267``).

Inputs are made with numpy from a seed and handed to both packages: 160
points (not a multiple of the TPU tile's 128, so the JAX side is padded
with zero points, as ``field.aggregate_color`` pads), each with 8 pair
rows, 30 % of the slots invalid (wn = 0, x_pi of a far row-0 neighbour)
and the first 5 points without any valid neighbour.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair_mlp import jax_field_state

from spurfies_tpu.config import ModelConfig
from spurfies_tpu.model import field as jfield
from spurfies_tpu.model.networks import init_model_params
from spurfies_tpu.ops import pallas_color as jpc
from spurfies_tpu_torch.convert.from_jax import params_from_numpy
from spurfies_tpu_torch.model import field as tfield
from spurfies_tpu_torch.ops import fused_color as tfc

M, K = 160, 8
PAD = 256                   # the JAX kernel's grid takes whole 128-point tiles
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _dir_enc(dirs):
    parts = [dirs]
    for i in range(3):
        parts += [np.sin(dirs * 2.0 ** i), np.cos(dirs * 2.0 ** i)]
    return np.concatenate(parts, -1).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    params = init_model_params(jax.random.PRNGKey(1), ModelConfig())
    nets = {k: jax.tree_util.tree_map(np.asarray, params["train"][k])
            for k in ("F_color", "R")}
    rng = np.random.default_rng(7)
    valid = rng.uniform(size=(M, K)) > 0.3
    valid[:5] = False
    x_pi = rng.normal(0, 0.03, (M, K, 3))
    x_pi[~valid] = rng.uniform(-1, 1, (int((~valid).sum()), 3))
    w = rng.uniform(0.05, 1.0, (M, K)) * valid
    den = w.sum(1, keepdims=True)
    wn = w / np.where(den > 0, den, 1.0)
    dirs = rng.normal(size=(M, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    arrs = {"x_pi": x_pi.reshape(-1, 3), "lat": rng.normal(0, 0.3, (M * K, 64)),
            "wn": wn.reshape(-1), "dir_enc": _dir_enc(dirs),
            "rgb_bar": rng.normal(size=(M, 3))}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    return nets, arrs


def _jax_args(setup):
    """The JAX kernels' inputs, padded with zero points to PAD."""
    nets, a = setup
    pad = lambda v, n: np.pad(v, ((0, n - v.shape[0]),) + ((0, 0),)  # noqa
                              * (v.ndim - 1))
    ins = (pad(a["x_pi"], PAD * K), pad(a["lat"], PAD * K),
           pad(a["wn"], PAD * K)[:, None], pad(a["dir_enc"], PAD))
    fws = tuple(jnp.asarray(l["w"]) for l in nets["F_color"])
    fbs = tuple(jnp.asarray(l["b"])[None] for l in nets["F_color"])
    rws = tuple(jnp.asarray(l["w"]) for l in nets["R"])
    rbs = tuple(jnp.asarray(l["b"])[None] for l in nets["R"])
    return ([jnp.asarray(v) for v in ins], (fws, fbs, rws, rbs),
            jnp.asarray(pad(a["rgb_bar"], PAD)))


def _port_args(setup):
    nets, a = setup
    t = params_from_numpy(nets, device="cpu")
    return ([torch.from_numpy(a[k]) for k in ("x_pi", "lat", "wn",
                                              "dir_enc")],
            t["F_color"], t["R"], torch.from_numpy(a["rgb_bar"]))


@pytest.fixture(scope="module")
def jax_kernels(setup):
    """The interpret-mode JAX kernels' outputs, by dtype: (rgb, (dlat, dws,
    dbs)), cut to the 160 real points."""
    ins, ws, rgb_bar = _jax_args(setup)
    out = {}
    for name, (jdt, _) in DT.items():
        rgb = jpc._color_fwd_call(*ins, *ws, dt=jdt, interpret=True)
        dlat, dws, dbs = jpc._color_bwd_call(*ins, *ws, rgb_bar, dt=jdt,
                                             interpret=True)
        out[name] = (np.asarray(rgb)[:M], (np.asarray(dlat)[:M * K],
                                           [np.asarray(d) for d in dws],
                                           [np.asarray(d)[0] for d in dbs]))
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _share_within(got, ref, share):
    """Per column: |got - ref| <= 2**-6 |ref| + 1e-3 of the column's max
    |ref| on all but ``share`` of the entries, and <= 0.05 of it on all."""
    got, ref = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    scale = np.abs(ref).max(0) + 1e-30
    d = np.abs(got - ref)
    assert (d > 2.0 ** -6 * np.abs(ref) + 1e-3 * scale).mean() <= share
    assert (d / scale).max() <= 0.05


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fwd_plain_matches_jax_kernel(setup, jax_kernels, dt):
    """Plain K8a against ``_color_fwd_call``.  f32: the same products with
    f32 sums in another order, test_pallas_mlp.py:224's rtol 1e-4 / atol
    1e-5.  bf16: both round at the same points, so only a bf16 rounding
    that the sums' order moves by one ulp (2**-8) differs and carries
    through the layers; rgb (after the sigmoid) is held to 2**-6 relative
    + 1e-3 of the scale on 99.5 % of the entries and 0.05 of the scale on
    all, as test_torch_pair_mlp.py holds K3 in bf16."""
    ins, f_color, r, _ = _port_args(setup)
    rgb = tfc.fused_color_fwd(*ins, f_color, r, DT[dt][1])
    ref = jax_kernels[dt][0]
    assert rgb.shape == (M, 3) and rgb.dtype == torch.float32
    if dt == "f32":
        np.testing.assert_allclose(rgb.numpy(), ref, rtol=1e-4, atol=1e-5)
    else:
        _share_within(rgb.numpy(), ref, 0.005)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bwd_plain_matches_jax_kernel(setup, jax_kernels, dt):
    """Plain K8b against ``_color_bwd_call``: dlat, and dW/db of every
    layer.  f32: test_pallas_mlp.py:248-266's rtol 1e-3 with atol 1e-5
    (dlat) and 2e-4 (weights).  bf16: each delta is rounded to bf16 before
    each product on both sides, so a rounding that the f32 sums' order
    moves by one ulp can flip a LeakyReLU gate whose pre-activation lies
    within an ulp of 0, and that row's delta then changes from that layer
    down; at 1,280 pairs a few such rows dominate.  dlat and every dW/db
    are held to 4e-2 relative L2 (measured: at most 1.55e-2; the plain
    version with f64 sums instead of f32 reads the same 1.55e-2 against
    itself, so this is the sum order alone).  On the card, at a training
    step's 212,992 pairs, kernel and plain read 1.3e-3 (dlat) and at most
    4.5e-5 (dW/db): PERF.md, section 6."""
    ins, f_color, r, rgb_bar = _port_args(setup)
    dlat, dws, dbs = tfc.fused_color_bwd(*ins, f_color, r, rgb_bar,
                                         DT[dt][1])
    rl, rws, rbs = jax_kernels[dt][1]
    assert dlat.shape == (M * K, 64)
    for got, ref in zip(dws + dbs, rws + rbs):
        assert tuple(got.shape) == ref.shape
    if dt == "f32":
        np.testing.assert_allclose(dlat.numpy(), rl, rtol=1e-3, atol=1e-5)
        for i, (got, ref) in enumerate(zip(dws + dbs, rws + rbs)):
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3,
                                       atol=2e-4, err_msg=f"grad {i}")
    else:
        assert _rel_l2(dlat.numpy(), rl) < 4e-2
        for i, (got, ref) in enumerate(zip(dws + dbs, rws + rbs)):
            assert _rel_l2(got.numpy(), ref) < 4e-2, i
    # no valid neighbour: no latent gradient
    assert float(dlat[:5 * K].abs().max()) == 0.0


def test_fused_color_function_matches_jax_grad(setup):
    """``FusedColor`` through ``torch.autograd.grad`` against ``jax.grad``
    of ``pallas_color.fused_color``, in f32, by test_pallas_mlp.py's
    limits; x_pi, wn and dir_enc get no gradient (the JAX VJP's zeros)."""
    nets, a = setup
    (x, lat, wn, de), _, rgb_bar = _jax_args(setup)
    tp = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in nets.items()}

    def jloss(p, lat):
        return jnp.sum(jpc.fused_color(p, x, lat, wn, de, jnp.float32)
                       * rgb_bar)

    gp, glat = jax.grad(jloss, argnums=(0, 1))(tp, lat)
    ins, f_color, r, c = _port_args(setup)
    for t in ins:
        t.requires_grad_(True)
    leaves = [l[k] for l in f_color + r for k in ("w", "b")]
    for t in leaves:
        t.requires_grad_(True)
    rgb = tfc.fused_color(f_color, r, *ins, torch.float32)
    grads = torch.autograd.grad(
        (rgb * c).sum(), [ins[1]] + leaves + [ins[0], ins[2], ins[3]],
        allow_unused=True)
    assert all(g is None for g in grads[-3:])
    grads = grads[:-3]
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(glat)[:M * K],
                               rtol=1e-3, atol=1e-5)
    ref = [np.asarray(gp[n][i][k]) for n in ("F_color", "R")
           for i in range(len(nets[n])) for k in ("w", "b")]
    for i, (got, want) in enumerate(zip(grads[1:], ref)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-4,
                                   err_msg=f"leaf {i}")


@pytest.fixture(scope="module")
def scene():
    """tests/test_pallas_mlp.py::TestFusedColor's scene: 2000 points on a
    sphere, 160 shading points beside the cloud, their kNN and unit view
    directions; the JAX trainable tree and its port twin."""
    from spurfies_tpu.model.neural_points import build_scene
    from spurfies_tpu.ops.voxel_grid import query_grid

    cfg = ModelConfig()
    rng = np.random.default_rng(11)
    v = rng.normal(size=(2000, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = (0.5 * v).astype(np.float32)
    jscene, latents = build_scene(jax.random.PRNGKey(0), pts, cfg,
                                  rng.uniform(0, 255, (2000, 3)))
    params = init_model_params(jax.random.PRNGKey(1), cfg)
    tp = {k: params["train"][k] for k in ("F_color", "R")}
    tp["feats_color"] = latents["feats_color"]
    x = jscene.points[:M] + jnp.asarray(
        rng.normal(0, 0.01, (M, 3)).astype(np.float32))
    idx, _ = query_grid(x, jscene.table, jscene.spec, k=cfg.k)
    dirs = rng.normal(size=(M, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    c = rng.normal(size=(M, 3)).astype(np.float32)
    j = {"tp": tp, "points": jscene.points, "idx": idx, "valid": idx >= 0,
         "x": x, "dirs": jnp.asarray(dirs), "c": jnp.asarray(c)}
    t = {k: (params_from_numpy(jax.tree_util.tree_map(np.asarray, v), "cpu")
             if k == "tp" else torch.from_numpy(np.array(v)))
         for k, v in j.items()}
    t["idx"] = t["idx"].to(torch.int32)
    return j, t


def _jax_colour(j, fused):
    def loss(tp):
        rgb = jfield.aggregate_color(tp, tp["feats_color"], j["points"],
                                     j["idx"], j["valid"], j["x"], j["dirs"],
                                     45.0, 6, 3, compute_dtype=None)
        return jnp.sum(rgb * j["c"]), rgb

    with jax_field_state(dtype=jnp.float32, fused_color=fused):
        (_, rgb), g = jax.value_and_grad(loss, has_aux=True)(j["tp"])
    return np.asarray(rgb), g


def _port_colour(t, fused):
    tp = {k: v for k, v in t["tp"].items()}
    leaves = [tp["feats_color"]] + [l[k] for n in ("F_color", "R")
                                    for l in tp[n] for k in ("w", "b")]
    for leaf in leaves:
        leaf.requires_grad_(True)
    saved = tfield.FUSED_COLOR
    try:
        tfield.FUSED_COLOR = fused
        rgb = tfield.aggregate_color(tp, tp["feats_color"], t["points"],
                                     t["idx"], t["valid"], t["x"], t["dirs"],
                                     45.0, 6, 3, compute_dtype=None,
                                     fused_dtype=torch.float32)
    finally:
        tfield.FUSED_COLOR = saved
    grads = torch.autograd.grad((rgb * t["c"]).sum(), leaves)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return rgb.detach().numpy(), [g.numpy() for g in grads]


def _jax_leaves(g):
    return [np.asarray(g["feats_color"])] + [
        np.asarray(g[n][i][k]) for n in ("F_color", "R")
        for i in range(len(g[n])) for k in ("w", "b")]


@pytest.mark.parametrize("against", ["jax_fused", "port_dense"])
def test_aggregate_color_fused_branch(scene, against):
    """The port's ``aggregate_color`` under ``FUSED_COLOR`` (f32, through
    K5 for the latents) against the JAX package's under ``FUSED_COLOR``
    (interpret mode, f32), and against the port's own dense branch in f32
    (linear-tail fold, f32 sums in another order): rgb within rtol 1e-4 /
    atol 1e-5, the gradients of feats_color within rtol 1e-3 / atol 1e-5
    and of F_color / R within rtol 1e-3 / atol 2e-4 -- the limits of
    tests/test_pallas_mlp.py::TestFusedColor."""
    j, t = scene
    rgb, grads = _port_colour(t, fused=True)
    if against == "jax_fused":
        ref, g = _jax_colour(j, fused=True)
        ref_grads = _jax_leaves(g)
    else:
        ref, ref_grads = _port_colour(t, fused=False)
    np.testing.assert_allclose(rgb, ref, rtol=1e-4, atol=1e-5)
    for i, (got, want) in enumerate(zip(grads, ref_grads)):
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-5 if i == 0 else 2e-4,
                                   err_msg=f"leaf {i}")
    assert not tfield.FUSED_COLOR


def test_wrappers_check_their_inputs(setup):
    """Wrong shapes, dtypes or layer counts raise before any work."""
    ins, f_color, r, rgb_bar = _port_args(setup)
    x_pi, lat, wn, de = ins
    for bad in ((x_pi, lat[:, :32], wn, de), (x_pi, lat, wn[:, None], de),
                (x_pi, lat, wn, de.double())):
        with pytest.raises(ValueError):
            tfc.fused_color_fwd(*bad, f_color, r, torch.float32)
    with pytest.raises(ValueError, match="layers"):
        tfc.fused_color_fwd(*ins, f_color[:3], r, torch.float32)
    with pytest.raises(ValueError, match="rgb_bar"):
        tfc.fused_color_bwd(*ins, f_color, r, rgb_bar[:, :2], torch.float32)
