"""The local (Vis-MVSNet) feature loss against the JAX package, on the CPU:
the four loss functions (``model/local_loss.py``), the frozen extractor
layer by layer on carried-across weights (``model/featext.py``), the
checkpoint converter on a synthetic state dict in the reference's key
layout, the bilinear resize against ``cv2.resize(INTER_LINEAR)``, the
bundle built from a fixture directory (``data/mvs_local.py``), one
training step with the bundle, and the training CLI with a random-weight
``ckpt/vismvsnet.pt``.

The real checkpoint and DTU's ``DTU_pixelnerf`` images and ``cam4feat``
cameras are not in the repository: the state dict is
``data.synthetic.random_vismvsnet_state``'s, the fixtures
``export_synthetic_mvs``'s, written from the synthetic DTU export.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import json
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_cli import TINY_OVERRIDES
from test_torch_train import (  # noqa: F401  (world is a fixture)
    _batch,
    _configs,
    _grad_tree,
    _leaf_names,
    _rel_err,
    _t_params,
    jax_batch_draws,
    jax_render_draws,
    world,
)

from spurfies_tpu.convert import torch2jax
from spurfies_tpu.data import mvs_local as jmvs
from spurfies_tpu.model import featext as jfeat
from spurfies_tpu.model import local_loss as jll
from spurfies_tpu.model import losses as jlosses
from spurfies_tpu.model import renderer as jren
from spurfies_tpu.train import trainer as jtrainer
from spurfies_tpu.train.optim import build_optimizer
from spurfies_tpu_torch.cli import train as cli_train
from spurfies_tpu_torch.convert.from_jax import featext_from_jax
from spurfies_tpu_torch.convert.torch_ckpt import convert_vismvsnet
from spurfies_tpu_torch.data import mvs_local as tmvs
from spurfies_tpu_torch.data.scene_data import resize_linear
from spurfies_tpu_torch.data.synthetic import (
    export_synthetic_dtu,
    export_synthetic_mvs,
    random_vismvsnet_state,
)
from spurfies_tpu_torch.model import local_loss as tll
from spurfies_tpu_torch.model.featext import FeatExt
from spurfies_tpu_torch.train import trainer as ttrainer
from spurfies_tpu_torch.train.optim import Optimizer, flatten


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the four functions ----------------------------------------------------

@pytest.mark.parametrize("sdf,valid,expect", [
    ([0.5, 0.1, -0.1, -0.5], [1, 1, 1, 1], 2.5),            # one crossing
    ([-0.5, 0.5, 1.0, 1.0], [1, 1, 1, 1], None),            # exit only
    ([1000.0, 0.1, -0.1, 1000.0], [0, 1, 1, 0], 2.5),       # filler ignored
    ([0.2, -0.2, 0.2, -0.2], [1, 1, 1, 1], 1.5)])           # first wins
def test_find_surface_depth_cases(sdf, valid, expect):
    """``tests/test_local_loss.py``'s cases: z = 1, 2, 3, 4."""
    z = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    d, m = tll.find_surface_depth(torch.tensor([sdf]), z,
                                  torch.tensor([valid], dtype=torch.bool))
    assert bool(m[0]) == (expect is not None)
    np.testing.assert_allclose(float(d[0]), expect or 0.0, atol=1e-5)


def test_find_surface_depth_matches_jax():
    """Random rays (crossings of both signs, fillers, invalid samples): the
    mask equal, the depth within 1e-6, and its gradient in the SDF within
    2e-3 relative: the lerp's quotient rule divides by (s0 - s1)^2, which
    the two frameworks round in another order (measured: 5.8e-4 on 33 of
    4,800 entries, 0 elsewhere).  JAX's gradient is NaN on the rays whose
    first two samples are both fillers (0/0, see the next test); a render
    masks those samples, and the port's gradient there is 0."""
    rng = np.random.default_rng(0)
    sdf = rng.normal(0, 0.3, (200, 24)).astype(np.float32)
    valid = rng.random((200, 24)) > 0.2
    sdf = np.where(valid, sdf, 1000.0).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 3.0, (200, 24)), -1).astype(np.float32)

    def jf(s):
        d, m = jll.find_surface_depth(s, jnp.asarray(z), jnp.asarray(valid))
        return jnp.sum(d * jnp.arange(200.0)), (d, m)

    (_, (dj, mj)), gj = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(sdf))
    s_t = _t(sdf).requires_grad_(True)
    dt, mt = tll.find_surface_depth(s_t, _t(z), _t(valid))
    (gt,) = torch.autograd.grad(torch.sum(dt * torch.arange(200.0)), s_t)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert 0.2 < mt.numpy().mean() < 1
    np.testing.assert_allclose(dt.detach().numpy(), np.asarray(dj),
                               rtol=1e-6, atol=1e-6)
    gj = np.asarray(gj)
    fin = np.isfinite(gj)
    assert np.isfinite(gt.numpy()).all() and not valid[~fin].any()
    assert (gt.numpy()[~fin] == 0).all()
    np.testing.assert_allclose(gt.numpy()[fin], gj[fin], rtol=2e-3,
                               atol=1e-6)


def test_find_surface_depth_gradient_is_finite_where_jax_is_nan():
    """A ray with no crossing whose first two samples carry the same SDF
    (two samples a few ulps apart, as the sampler can merge): JAX divides
    by s0 - s1 = 0 before it selects, and its gradient is NaN, which makes
    its finite guard skip the whole training step; the port divides only
    where |s0 - s1| > 1e-12, so its gradient there is 0.  The value, and
    the gradient of every other ray, are the same."""
    sdf = np.array([[0.0106, 0.0106, 0.0107, 0.0108],
                    [0.5, 0.1, -0.1, -0.5]], np.float32)
    z = np.array([[1.0, 1.000002, 1.1, 1.2], [1.0, 2.0, 3.0, 4.0]],
                 np.float32)
    valid = np.ones((2, 4), bool)

    def jf(s):
        return jnp.sum(jll.find_surface_depth(s, jnp.asarray(z),
                                              jnp.asarray(valid))[0])

    gj = np.asarray(jax.grad(jf)(jnp.asarray(sdf)))
    s_t = _t(sdf).requires_grad_(True)
    dt, mt = tll.find_surface_depth(s_t, _t(z), _t(valid))
    (gt,) = torch.autograd.grad(dt.sum(), s_t)
    assert np.isnan(gj[0]).any() and np.isfinite(gj[1]).all()
    assert mt.tolist() == [False, True]
    np.testing.assert_allclose(dt.detach().numpy(), [0.0, 2.5], atol=1e-6)
    np.testing.assert_array_equal(gt.numpy()[0], 0.0)
    np.testing.assert_allclose(gt.numpy()[1], gj[1], rtol=1e-6)


def test_grid_sample_matches_torch_and_jax():
    """The four-tap sample is ``F.grid_sample(bilinear, zeros,
    align_corners=False)`` (``tests/test_local_loss.py``'s check, 1e-5)
    and JAX's function, values and gradients in the features and the
    coordinates, within 1e-5."""
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(9, 13, 4)).astype(np.float32)       # HWC
    xy = rng.uniform(-2, 15, size=(50, 2)).astype(np.float32)
    h, w = 9, 13
    grid = np.stack([xy[:, 0] / w * 2 - 1, xy[:, 1] / h * 2 - 1], -1)
    ref = F.grid_sample(_t(feat.transpose(2, 0, 1))[None],
                        _t(grid[None, :, None, :]), mode="bilinear",
                        padding_mode="zeros",
                        align_corners=False)[0, :, :, 0].T.numpy()
    wts = rng.normal(size=(50, 4)).astype(np.float32)

    def jf(f, p):
        return jnp.sum(jll.grid_sample_bilinear(f, p) * wts)

    gj = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(feat),
                                                jnp.asarray(xy))
    f_t = _t(feat).requires_grad_(True)
    xy_t = _t(xy).requires_grad_(True)
    out = tll.grid_sample_bilinear(f_t, xy_t)
    gt = torch.autograd.grad(torch.sum(out * _t(wts)), (f_t, xy_t))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jll.grid_sample_bilinear(jnp.asarray(feat),
                                            jnp.asarray(xy))), atol=1e-6)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_project_mvs_known_camera():
    ext = np.eye(4, dtype=np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 100.0
    K[0, 2], K[1, 2] = 32.0, 24.0
    xy, z = tll.project_mvs(torch.tensor([[0.0, 0.0, 2.0], [0.1, -0.1, 1.0]]),
                            _t(np.stack([ext, K])))
    np.testing.assert_allclose(xy.numpy(), [[32.0, 24.0], [42.0, 14.0]],
                               atol=1e-4)
    np.testing.assert_allclose(z.numpy(), [2.0, 1.0], atol=1e-6)


def _toy_cams(rng, n_src):
    ext = np.eye(4, dtype=np.float32)
    ext[2, 3] = 2.0                                  # points in front
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 20.0
    K[0, 2], K[1, 2] = 20.0, 16.0
    cam = np.stack([ext, K])
    src = np.repeat(cam[None], n_src, 0)
    src[:, 0, :3, 3] += rng.normal(0, 0.05, (n_src, 3))  # shifted sources
    return cam, src


def test_local_loss_identical_views_zero_and_different_positive(rng):
    """``tests/test_local_loss.py``: the same map and camera give 0; a
    perturbed map (corr < 1, corr_loss < 0.5) gives > 0."""
    feat1 = rng.normal(size=(16, 20, 8)).astype(np.float32)
    feat2 = (feat1 + 0.2 * rng.normal(size=(16, 20, 8))).astype(np.float32)
    cam, _ = _toy_cams(rng, 1)
    pts = _t(rng.uniform(-0.2, 0.2, (64, 3)).astype(np.float32))
    args = (torch.ones(64, dtype=torch.bool), _t(feat1))
    same = tll.local_feature_loss(pts, *args, _t(feat1)[None], _t(cam),
                                  _t(cam)[None], torch.tensor(1.0),
                                  torch.zeros(3))
    diff = tll.local_feature_loss(pts, *args, _t(feat2)[None], _t(cam),
                                  _t(cam)[None], torch.tensor(1.0),
                                  torch.zeros(3))
    np.testing.assert_allclose(float(same), 0.0, atol=1e-5)
    assert float(diff) > 0.0


def test_local_loss_matches_jax(rng):
    """Two source views, smooth features (a random linear map of a smooth
    field, so most terms are kept), points partly out of range and a
    partial surface mask: the loss and its gradients in the points and the
    three feature maps within 1e-5 relative (measured ~1e-7)."""
    yy, xx = np.mgrid[0:16, 0:20].astype(np.float32)
    base = np.stack([np.sin(xx / 3), np.cos(yy / 4), xx * yy / 300], -1)
    feats = np.stack([base @ rng.normal(size=(3, 8)) + 0.1 * v
                      for v in range(3)]).astype(np.float32)
    cam, src = _toy_cams(rng, 2)
    pts = rng.uniform(-0.4, 0.4, (96, 3)).astype(np.float32)
    mask = rng.random(96) > 0.2
    size, center = np.float32(1.5), np.asarray([0.01, -0.02, 0.0],
                                               np.float32)

    def jf(p, f):
        return jll.local_feature_loss(p, jnp.asarray(mask), f[0], f[1:],
                                      jnp.asarray(cam), jnp.asarray(src),
                                      jnp.asarray(size), jnp.asarray(center))

    vj, gj = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        jnp.asarray(pts), jnp.asarray(feats))
    p_t = _t(pts).requires_grad_(True)
    f_t = _t(feats).requires_grad_(True)
    vt = tll.local_feature_loss(p_t, _t(mask), f_t[0], f_t[1:], _t(cam),
                                _t(src), torch.tensor(size), _t(center))
    gt = torch.autograd.grad(vt, (p_t, f_t))
    assert float(vj) > 0
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    for a, b in zip(gt, gj):
        assert np.isfinite(a.numpy()).all()
        assert _rel_err(a.numpy(), np.asarray(b)) < 1e-5


# ---- the extractor and its converter ---------------------------------------

@pytest.fixture(scope="module")
def vismvsnet():
    """(the synthetic checkpoint, JAX's converted tree, the port's
    module from the same checkpoint)."""
    state = random_vismvsnet_state(0)
    return state, torch2jax.convert_vismvsnet(state), convert_vismvsnet(
        state, "cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f"{k}.{n}", v) for k in sorted(tree)
                for n, v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}.{n}", v) for i, t in enumerate(tree)
                for n, v in _leaves(t)]
    return [("", tree)]


@pytest.mark.parametrize("stripped", [False, True])
def test_convert_vismvsnet_matches_jax(vismvsnet, stripped):
    """The port's converter on the full checkpoint and on the stripped
    feat_ext subtree gives JAX's tree carried across
    (``from_jax.featext_from_jax``), bit for bit: every conv kernel (OIHW,
    the transposed convolutions IOHW), every folded BN and every stride."""
    state, j_tree, _ = vismvsnet
    if stripped:
        state = {k[len("module.feat_ext."):]: v
                 for k, v in state["state_dict"].items()}
    port = _leaves(convert_vismvsnet(state, "cpu").params)
    carried = _leaves(featext_from_jax(j_tree))
    assert [n for n, _ in port] == [n for n, _ in carried]
    assert len(port) == 75
    for (name, a), (_, b) in zip(port, carried):
        if isinstance(b, int):                          # a block's stride
            assert a == b, name
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_featext_stages_match_jax(vismvsnet):
    """The extractor on carried-across weights, stage by stage (init,
    enc0-2, dec0-1, f1-f3), against ``featext_apply`` on a 64x96 batch of
    two: each within 1e-4 of the stage's scale (f32 convolutions in
    another sum order; measured ~1e-6), and the shapes at 1/2 .. 1/8."""
    _, j_tree, _ = vismvsnet
    x = np.random.default_rng(1).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    _, stages_j = jfeat.featext_apply(j_tree, jnp.asarray(x),
                                      return_stages=True)
    fx = FeatExt(featext_from_jax(j_tree))
    with torch.no_grad():
        (f1, f2, f3), stages_t = fx(_t(x.transpose(0, 3, 1, 2)),
                                    return_stages=True)
    assert set(stages_t) == set(stages_j) == {
        "init", "enc0", "enc1", "enc2", "dec0", "dec1", "f1", "f2", "f3"}
    assert f3.shape == (2, 32, 32, 48) and f1.shape == (2, 32, 8, 12)
    for name, b in stages_j.items():
        a = stages_t[name].numpy().transpose(0, 2, 3, 1)
        b = np.asarray(b)
        assert a.shape == b.shape, name
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-4 * scale, name


# ---- the data layer -------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((300, 400), (768, 1024)),
                                     ((1200, 1600), (768, 1024)),
                                     ((37, 53), (64, 96)),
                                     ((48, 64), (40, 50))])
def test_resize_linear_matches_cv2(src, dst):
    """``resize_linear`` is ``cv2.resize(INTER_LINEAR)`` on float32 images
    (up and down, odd sizes) within ``max(H, W) * 2**-22`` on [0, 1]
    images, the cubic resize's rule (``scene_data.resize_cubic``): the two
    compute the source position in f32 each their own way, a few ulps of
    the position apart (measured: 3.5e-6 at 53 px, where the limit is
    1.3e-5; 2e-7 at 1600 px)."""
    img = np.random.default_rng(0).random(src + (3,)).astype(np.float32)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    out = resize_linear(img, dst)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=max(src) * 2.0 ** -22)


@pytest.fixture(scope="module")
def mvs_fixture(tmp_path_factory):
    """A synthetic DTU scan (48x64, 29 views: the train views 25, 22, 28
    exist) with its Vis-MVSNet fixtures."""
    root = tmp_path_factory.mktemp("mvs")
    data = str(root / "data")
    export_synthetic_dtu(data, scan_id=24, n_views=49, img_res=(48, 64),
                         n_points=2000)
    ids = export_synthetic_mvs(data, scan_id=24)
    return root, data, ids


def test_mvs_fixture_parses_and_reads_bgr(mvs_fixture):
    """The written cameras parse back (pair order = the train order, the
    intrinsics at 384x512 = the export's scaled by 8) and ``read_bgr`` is
    ``cv2.imread``."""
    _, data, ids = mvs_fixture
    cam_dir = os.path.join(data, "dtu", "DTU_pixelnerf", "dtu_scan24",
                           "cam4feat")
    assert tmvs.parse_pair(os.path.join(cam_dir, "pair.txt")) == [
        str(i) for i in ids] == jmvs.parse_pair(
        os.path.join(cam_dir, "pair.txt"))
    for i in ids:
        path = os.path.join(cam_dir, f"cam_{i:08d}_flow3.txt")
        np.testing.assert_array_equal(tmvs.parse_mvs_cam(path),
                                      jmvs.parse_mvs_cam(path))
    img_dir = os.path.join(data, "dtu", "DTU_pixelnerf", "dtu_scan24",
                           "image")
    for name in sorted(os.listdir(img_dir)):
        p = os.path.join(img_dir, name)
        np.testing.assert_array_equal(tmvs.read_bgr(p), cv2.imread(p))


def test_build_local_bundle_matches_jax(mvs_fixture, vismvsnet):
    """The bundle from the fixture directory through both packages on the
    same weights (``feat_img_scale=1``: 384x512 images, 192x256 features,
    a quarter of the default's work): the hd cameras, size and center
    equal, the features within 2e-4 of their scale (the resize within 2e-6,
    then f32 convolutions in another sum order)."""
    _, data, _ = mvs_fixture
    state, j_tree, fx = vismvsnet
    scale_mat = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    scale_mat[0, 3] = 0.05
    jb = jmvs.build_local_bundle(data, 24, j_tree, scale_mat,
                                 feat_img_scale=1)
    tb = tmvs.build_local_bundle(data, 24, fx, scale_mat, feat_img_scale=1,
                                 device="cpu")
    assert tb.feats.shape == jb.feats.shape == (3, 192, 256, 32)
    np.testing.assert_array_equal(tb.cams_hd.numpy(), jb.cams_hd)
    assert tb.size == jb.size == 4.0
    np.testing.assert_array_equal(tb.center.numpy(), jb.center)
    scale = np.abs(jb.feats).max()
    assert np.abs(tb.feats.numpy() - jb.feats).max() <= 2e-4 * scale
    view = tb.for_view(1)
    assert view["feats_src"].shape[0] == 2 and view["size"] == 4.0


# ---- training with the bundle ----------------------------------------------

def _synthetic_bundle(world):
    """A local bundle on the train world's three views: features a smooth
    function of each view's image (so corresponding points correlate), the
    hd cameras its w2c and 2x its intrinsics (features at half the hd
    resolution = the image's), the identity world frame (size 2, center
    0)."""
    v = world["views"]
    h, w = 24, 40
    rgb = v["rgb"].reshape(-1, h, w, 3)
    a = np.random.default_rng(4).normal(size=(3, 32)).astype(np.float32)
    feats = np.tanh(rgb @ a + 0.3).astype(np.float32)
    cams = np.zeros((3, 2, 4, 4), np.float32)
    for i in range(3):
        cams[i, 0] = np.linalg.inv(v["pose"][i])
        cams[i, 1] = v["intrinsics"][i]
        cams[i, 1, :2] *= 2.0
    return jmvs.LocalBundle(feats=feats, cams_hd=cams, size=2.0,
                            center=np.zeros(3, np.float32))


def _jax_ctx(b):
    return {"feats": jnp.asarray(b.feats), "cams": jnp.asarray(b.cams_hd),
            "src": jnp.asarray([jmvs.SRC_MAP[i] for i in range(3)],
                               jnp.int32),
            "size": jnp.asarray(b.size), "center": jnp.asarray(b.center)}


# the local term's limit: the surface point is a lerp that divides by
# s0 - s1, and its features a bilinear sample of the maps at the point's
# projection, so the geometry's f32 sum-order differences (depth 1e-4, the
# crossing's z within 4.4e-6 on this batch, the same rays crossing) move
# the term by more than they move the other parts (measured: 1.07e-3
# relative on the term, 1.3e-4 on the total)
LOCAL_RTOL = 5e-3


def test_local_loss_term_and_grads_match_jax(world):
    """The training loss with the local term (``trainer.py:209-227``: the
    surface from the render's sdf, z_sel and valid_pt, the batch's view 0
    and its sources 1, 2), through the port's ``loss_fn`` and JAX's
    functions, with the JAX draws: the local term non-zero and within
    ``LOCAL_RTOL`` as the total, the other parts by
    ``tests/test_torch_train.py``'s limit (1e-3 relative), and the
    gradients of every trained tensor by its limits (geometry and beta
    2e-3, colour 4e-2 relative L2).  JAX's geometry gradient is NaN on the
    latent rows of one ray's 0/0 (see
    ``test_find_surface_depth_gradient_is_finite_where_jax_is_nan``) and on
    the rows its latent-gradient kernel spreads that NaN to: the port's is
    finite everywhere, and it is held to JAX's on the rows where JAX's is
    finite."""
    cfg, tcfg = _configs(["model.ray_budget_frac=0.6",
                          "model.probe_budget_frac=0.5"])
    bundle = _synthetic_bundle(world)
    ctx = _jax_ctx(bundle)
    key = jax.random.PRNGKey(11)
    j_in, j_gt, t_in, t_gt = _batch(world, 256, seed=5)

    def local(out):
        d, m = jll.find_surface_depth(out["sdf"], out["z_sel"],
                                      out["valid_pt"])
        surf = out["cam_loc"] + out["ray_dirs"] * d[:, None]
        src = ctx["src"][0]
        return jll.local_feature_loss(surf, m & out["ray_mask"],
                                      ctx["feats"][0], ctx["feats"][src],
                                      ctx["cams"][0], ctx["cams"][src],
                                      ctx["size"], ctx["center"])

    def jloss(tp):
        params = {"frozen": world["frozen"], "train": tp}
        out = jren.render_rays(params, world["scene"], j_in, key, cfg.model,
                               train=True, iters=1)
        out["tv_loss"] = jren.tv_loss(params, world["scene"])
        out["pseudo_pts_loss"] = jren.pseudo_sdf_loss(params, world["scene"],
                                                      out, cfg.model)
        out["local_loss"] = local(out)
        return jlosses.total_loss(out, j_gt, cfg.loss)

    from test_torch_pair_mlp import jax_fused
    (lj, pj), gj = jax_fused(lambda: jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(world["tp"]))

    opt = Optimizer(tcfg.train)
    loss_fn, _, _ = ttrainer.make_train_step(tcfg, opt, "cpu",
                                             use_local=True)
    t_ctx = {"feats": _t(bundle.feats), "cams": _t(bundle.cams_hd),
             "src": torch.tensor([tmvs.SRC_MAP[i] for i in range(3)]),
             "size": torch.tensor(2.0), "center": torch.zeros(3)}
    tp = _t_params(world["tp"])
    batch = {"inputs": t_in, "gt": t_gt, "view": torch.tensor([0])}
    lt, pt = loss_fn(tp, {"scene": world["t_scene"], "prior": world["prior"],
                          "views": None, "local": t_ctx}, batch,
                     torch.zeros((), dtype=torch.int32),
                     draws=jax_render_draws(key, 256, tcfg.model))
    gt = torch.autograd.grad(lt, flatten({k: tp[k] for k in (
        "feats_geometry", "feats_color", "F_color", "R", "beta")}))
    assert float(pj["local_loss"]) > 0
    for name, v in pj.items():
        tol = LOCAL_RTOL if name in ("local_loss", "loss") else 1e-3
        np.testing.assert_allclose(float(pt[name].detach()), float(v),
                                   rtol=tol, atol=1e-7, err_msg=name)
    for a, b, name in zip(gt, _grad_tree(gj, world["tp"]),
                          _leaf_names(world["tp"])):
        a = a.numpy()
        assert np.isfinite(a).all(), name
        rows = np.isfinite(b).reshape(len(b), -1).all(-1) if b.ndim else (
            np.isfinite(b)[None])
        if name.startswith("feats_geometry"):
            # JAX's NaN rows: the NaN cotangent of one ray's two samples,
            # spread by its latent-gradient kernel over whole row blocks
            # (18 % of the rows on this batch)
            assert 0.5 < rows.mean() < 1, rows.mean()
            a, b = a[rows], b[rows]
        assert rows.all() or name.startswith("feats_geometry"), name
        tol = 2e-3 if name.startswith(("feats_geometry", "beta")) else 4e-2
        assert _rel_err(a, b) < tol, (name, _rel_err(a, b))


def test_train_step_with_bundle_matches_jax(world):
    """One ``train_step`` of each package's trainer with the bundle
    (JAX's ``make_train_step(use_local=True)``; the port's context as
    ``Trainer`` builds it), the JAX draws injected: the loss parts,
    local_loss among them, within ``LOCAL_RTOL``, and the step's guard."""
    cfg, tcfg = _configs(["model.ray_budget_frac=0.6",
                          "model.probe_budget_frac=0.5"])
    bundle = _synthetic_bundle(world)
    views = world["views"]
    tx = build_optimizer(cfg.train)
    _, j_step = jtrainer.make_train_step(cfg, tx, use_local=True)
    jb = {"scene": world["scene"], "frozen": world["frozen"],
          "views": {k: jnp.asarray(v) for k, v in views.items()},
          "local": _jax_ctx(bundle)}
    state = jtrainer.TrainState(world["tp"], tx.init(world["tp"]),
                                jnp.asarray(0, jnp.int32))
    key = jax.random.PRNGKey(21)
    from test_torch_pair_mlp import jax_fused
    _, pj = jax_fused(lambda: jax.jit(j_step)(jb, state, key))

    opt = Optimizer(tcfg.train)
    _, sample_batch, t_step = ttrainer.make_train_step(tcfg, opt, "cpu",
                                                       use_local=True)
    t_views = {k: torch.from_numpy(np.asarray(v)) for k, v in views.items()}
    v, pix = jax_batch_draws(jax.random.fold_in(key, 0), views,
                             cfg.train.num_pixels)
    tp = _t_params(world["tp"])
    t_state = ttrainer.TrainState(tp, opt.init(tp),
                                  torch.zeros((), dtype=torch.int32))
    t_ctx = {"feats": _t(bundle.feats), "cams": _t(bundle.cams_hd),
             "src": torch.tensor([tmvs.SRC_MAP[i] for i in range(3)]),
             "size": torch.tensor(2.0), "center": torch.zeros(3)}
    pt = t_step({"scene": world["t_scene"], "prior": world["prior"],
                 "views": t_views, "local": t_ctx}, t_state, None,
                draws=jax_render_draws(jax.random.fold_in(key, 1),
                                       cfg.train.num_pixels, tcfg.model),
                batch=sample_batch(t_views, None, v=v, pix=pix))
    assert float(pj["local_loss"]) > 0
    for name in ("loss", "rgb_loss", "local_loss", "pseudo_loss"):
        np.testing.assert_allclose(float(pt[name]), float(pj[name]),
                                   rtol=LOCAL_RTOL, err_msg=name)
    # JAX's step is skipped: one ray of this batch has two first samples
    # with the same SDF, and its lerp's 0/0 makes the gradient NaN (see
    # test_find_surface_depth_gradient_is_finite_where_jax_is_nan); the
    # port's gradient is finite and its step goes through
    assert float(pj["notfinite"]) == 1
    assert float(pt["notfinite"]) == 0


def test_trainer_holds_the_bundle_on_its_device(world):
    """``Trainer(local_bundle=...)`` builds the context on its device and
    trains with the local term: finite, non-zero on some steps; with
    ``loss.local_weight=0`` the bundle is ignored."""
    from spurfies_tpu_torch.config import apply_overrides as t_apply
    from spurfies_tpu_torch.config import Config as TConfig
    from spurfies_tpu_torch.convert.from_jax import load_prior_npz
    from spurfies_tpu_torch.data.synthetic import make_synthetic_scene

    pts, cols, views = make_synthetic_scene(n_points=1500, img_res=(24, 40))
    b = _synthetic_bundle({"views": views})
    bundle = tmvs.LocalBundle(feats=_t(b.feats), cams_hd=_t(b.cams_hd),
                              size=2.0, center=torch.zeros(3))
    cfg = t_apply(TConfig(), ["model.ray_sampler.n_samples_eval=32",
                              "model.ray_sampler.n_samples=32",
                              "model.max_shading_pts=48",
                              "model.color_top_samples=16",
                              "train.num_pixels=256"])
    tr = ttrainer.Trainer(cfg, pts, cols, views, local_bundle=bundle,
                          device="cpu", compute_dtype=torch.float32)
    tr.load_frozen(load_prior_npz(device="cpu"))
    assert tr.local_ctx["src"].tolist() == [[1, 2], [0, 2], [0, 1]]
    hist = []
    tr.run(4, window=1, callback=lambda s, m: hist.append(m))
    assert all(np.isfinite(m["local_loss"]) and m["notfinite"] == 0
               for m in hist)
    assert any(m["local_loss"] > 0 for m in hist)
    off = ttrainer.Trainer(t_apply(cfg, ["loss.local_weight=0"]), pts, cols,
                           views, local_bundle=bundle, device="cpu",
                           compute_dtype=torch.float32)
    assert off.local_ctx is None and "local" not in off.bundle


def test_cli_trains_with_the_local_loss(mvs_fixture, tmp_path, monkeypatch):
    """``cli.train.main`` on DTU with ``ckpt/vismvsnet.pt`` present (the
    random-weight checkpoint) and ``loss.local_weight=0.5``: it converts
    the checkpoint, builds the bundle (768x1024 features of the fixture's
    three views) and trains with the local term, finite and non-zero."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _, data, _ = mvs_fixture
    monkeypatch.chdir(tmp_path)
    os.makedirs("ckpt")
    torch.save(random_vismvsnet_state(0), os.path.join("ckpt",
                                                       "vismvsnet.pt"))
    built = {}
    real = cli_train.build_local_bundle

    def spy(*a, **k):
        built["bundle"] = real(*a, **k)
        return built["bundle"]

    monkeypatch.setattr(cli_train, "build_local_bundle", spy)
    ov = [o for o in TINY_OVERRIDES if not o.startswith(
        ("loss.local_weight", "train."))]
    [(trainer, exp)] = cli_train.main(
        ["--scans", "scan24", "--device", "cpu"] + ov + [
            f"dataset.data_dir_root={data}", "loss.local_weight=0.5",
            "train.num_pixels=128", "train.fast_iters=1",
            "train.eval_iters=1", "train.opt_steps=6", "train.render_freq=3",
            "train.checkpoint_freq=6"])
    assert built["bundle"].feats.shape == (3, 384, 512, 32)
    assert trainer.local_ctx is not None
    rows = [json.loads(ln) for ln in
            open(os.path.join(exp.plots_dir, "logs", "metrics.jsonl"))]
    rows = [r for r in rows if "local_loss" in r]
    assert [r["step"] for r in rows] == [3, 6]
    assert all(np.isfinite(r["local_loss"]) for r in rows)
