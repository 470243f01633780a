"""Prior pretraining (``spurfies_tpu_torch/prior``, ``cli/pretrain_prior``)
against the JAX package, on the CPU: the procedural shapes and the mesh
corpus (host numpy in both packages: the same arrays), the stacked corpus
and its query tables, one training step with the JAX draws injected, the
npz round trip, a few-step CLI run, and the finding that JAX's fused
(Pallas) path trains no decoder.

The JAX side runs its plain path (``FUSED_MLP_MODE`` "auto" on the CPU:
``vmap(value_and_grad)`` over ``aggregate_sdf``), which the port follows;
the corpus is small (2 shapes, 1,024 points, 512 queries, batches of 256)
and the port's tables keep ``n_points``, so its K1 takes the packed
variant, as on the card (JAX's CPU path is the exact ``lax.top_k``).
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import dataclasses
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_pair_mlp import jax_field_state

from spurfies_tpu.model import field as jfield
from spurfies_tpu.ops.voxel_grid import QueryTable as JQueryTable
from spurfies_tpu.ops.voxel_grid import query_grid as j_query_grid
from spurfies_tpu.prior import mesh_corpus as jmc
from spurfies_tpu.prior import pretrain as jpre
from spurfies_tpu.prior import shapes as jshapes
from spurfies_tpu_torch.cli import pretrain_prior as cli_pretrain
from spurfies_tpu_torch.config import Config as TConfig
from spurfies_tpu_torch.config import apply_overrides as t_apply
from spurfies_tpu_torch.convert.from_jax import params_from_numpy
from spurfies_tpu_torch.data.synthetic import make_synthetic_scene
from spurfies_tpu_torch.eval.marching import marching_tetrahedra
from spurfies_tpu_torch.prior import mesh_corpus as tmc
from spurfies_tpu_torch.prior import pretrain as tpre
from spurfies_tpu_torch.prior import shapes as tshapes
from spurfies_tpu_torch.train.optim import flatten
from spurfies_tpu_torch.train.trainer import Trainer

CFG = dict(n_shapes=2, n_surface_cap=1024, n_query=512, batch_queries=256,
           spacing=0.04, seed=0)


def _rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---- shapes and the mesh corpus -------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_sample_shape_is_jax(seed):
    """The same ``np.random.default_rng`` draws the same shape (each seed
    picks a kind: sphere, box, ellipsoid, torus, capsule), bit for bit."""
    a = tshapes.sample_shape(np.random.default_rng(seed), n_query=300,
                             spacing=0.04)
    b = jshapes.sample_shape(np.random.default_rng(seed), n_query=300,
                             spacing=0.04)
    assert set(a) == set(b) == {"surface", "query", "query_sdf"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _sphere_mesh(r=0.5, res=16):
    lin = np.linspace(-0.8, 0.8, res)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    verts, faces = marching_tetrahedra(np.linalg.norm(g, axis=-1) - r, 0.0,
                                       spacing=(lin[1] - lin[0],) * 3,
                                       origin=(-0.8,) * 3)
    return verts.astype(np.float32), faces


def _write_meshes(d):
    """An OBJ sphere (written by the port), the same mesh smaller as an
    ASCII PLY with a quad face, and a binary PLY tetrahedron."""
    verts, faces = _sphere_mesh()
    tmc.save_obj(os.path.join(d, "a.obj"), verts, faces)
    v = verts * 0.8
    with open(os.path.join(d, "b.ply"), "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(v) + 4}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(faces) + 1}\n"
                "property list uchar int vertex_indices\nend_header\n")
        for p in np.concatenate([v, [[0.9, 0.9, 0.9], [0.95, 0.9, 0.9],
                                     [0.95, 0.95, 0.9], [0.9, 0.95, 0.9]]]):
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
        n = len(v)
        f.write(f"4 {n} {n + 1} {n + 2} {n + 3}\n")
    tet = np.array([[0, 0, 0], [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5]],
                   np.float32)
    with open(os.path.join(d, "c.ply"), "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
                b"property float x\nproperty float y\nproperty float z\n"
                b"element face 4\nproperty list uchar int vertex_indices\n"
                b"end_header\n")
        f.write(tet.astype("<f4").tobytes())
        for t in ((0, 2, 1), (0, 1, 3), (0, 3, 2), (1, 2, 3)):
            f.write(struct.pack("<B3i", 3, *t))


def test_mesh_corpus_is_jax(tmp_path):
    """The readers (OBJ, ASCII PLY with a quad, binary PLY), the listing,
    ``normalize_mesh``, ``sample_surface``, ``orient_faces``,
    ``signed_distance`` and ``build_shapes_from_meshes`` give JAX's
    arrays, bit for bit."""
    _write_meshes(str(tmp_path))
    assert tmc.list_meshes(str(tmp_path)) == jmc.list_meshes(str(tmp_path))
    for name in ("a.obj", "b.ply", "c.ply"):
        va, fa = tmc.load_mesh(str(tmp_path / name))
        vb, fb = jmc.load_mesh(str(tmp_path / name))
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(fa, fb)
    va, fa = tmc.load_mesh(str(tmp_path / "b.ply"))
    assert len(fa) == len(_sphere_mesh()[1]) + 2          # the quad's fan
    v = tmc.normalize_mesh(va)
    np.testing.assert_array_equal(v, jmc.normalize_mesh(va))
    np.testing.assert_array_equal(tmc.sample_surface(v, fa, 500, seed=3),
                                  jmc.sample_surface(v, fa, 500, seed=3))
    np.testing.assert_array_equal(tmc.orient_faces(fa), jmc.orient_faces(fa))
    q = np.random.default_rng(0).uniform(-0.7, 0.7, (300, 3)).astype(
        np.float32)
    sd = tmc.signed_distance(v, fa, q)
    np.testing.assert_array_equal(sd, jmc.signed_distance(v, fa, q))
    assert (sd < 0).any() and (sd > 0).any()
    a = tmc.build_shapes_from_meshes(str(tmp_path), n_shapes=3, n_query=200,
                                     spacing=0.05)
    b = jmc.build_shapes_from_meshes(str(tmp_path), n_shapes=3, n_query=200,
                                     spacing=0.05)
    for sa, sb in zip(a, b):
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])


# ---- the corpus and one step ----------------------------------------------

@pytest.fixture(scope="module")
def corpora():
    """The corpus through both packages at ``CFG``."""
    cfg_j = jpre.PriorConfig(**CFG)
    cfg_t = tpre.PriorConfig(**CFG)
    cj, spec_j = jpre.build_corpus(cfg_j)
    ct, spec_t = tpre.build_corpus(cfg_t, device="cpu")
    return cfg_j, cfg_t, cj, spec_j, ct, spec_t


def test_build_corpus_is_jax(corpora):
    """Every stacked array -- the padded points and their mask, the
    queries and their SDF, the shapes' query tables -- equal to JAX's, bit
    for bit, with JAX's grid spec; the step's kNN query on shape 1's table
    finds JAX's neighbours: the same set per query, in the same order but
    where two lie within the packed key's rounding of each other (K1
    packed keeps the id in the low bits of d2, ROADMAP Queue 3)."""
    cfg_j, cfg_t, cj, spec_j, ct, spec_t = corpora
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)
    assert set(ct) == set(cj)
    for k in cj:
        np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]),
                                      err_msg=k)
    x = ct["query"][1][:256]
    idx_t, _ = tpre.query_grid(x, tpre.shape_table(ct, cfg_t, 1), spec_t, k=8)
    idx_j, _ = j_query_grid(jnp.asarray(x.numpy()), JQueryTable(
        idx=cj["table_idx"][1], pos=cj["table_pos"][1], r=cfg_j.r), spec_j,
        k=8)
    idx_j = np.asarray(idx_j)
    np.testing.assert_array_equal(np.sort(idx_t.numpy(), -1),
                                  np.sort(idx_j, -1))
    assert (idx_t.numpy() != idx_j).mean() < 1e-2
    assert (idx_t >= 0).any(-1).float().mean() > 0.5


def _ordered(tree):
    """A JAX tree (key-sorted dicts) as the port's: decoder then latents,
    each Linear ``{"w", "b"}``."""
    dec = {name: [{"w": np.asarray(l["w"]), "b": np.asarray(l["b"])}
                  for l in tree["decoder"][name]]
           for name in ("F_geometry", "T")}
    return {"decoder": dec, "latents": np.asarray(tree["latents"])}


def _jax_draws(key, cfg):
    """The draws of JAX's first window step (``pretrain.py:155-160``)."""
    k0 = jax.random.split(key, 1)[0]
    ks, kq = jax.random.split(k0)
    s = int(jax.random.randint(ks, (), 0, cfg.n_shapes))
    qidx = jax.random.choice(kq, cfg.n_query, (cfg.batch_queries,),
                             replace=False)
    return s, torch.from_numpy(np.array(qidx)).long()


def _jax_loss_and_grads(params, corpus, spec, cfg, s, qidx):
    """The loss and gradients of JAX's training step
    (``pretrain.py:124-152``) at its draws, through JAX's
    ``field.sdf_and_grad`` as the module's switches select it."""
    def loss_fn(p):
        x = corpus["query"][s][qidx]
        gt = corpus["query_sdf"][s][qidx]
        qt = JQueryTable(idx=corpus["table_idx"][s],
                         pos=corpus["table_pos"][s], r=cfg.r)
        idx, _ = j_query_grid(x, qt, spec, k=cfg.k)
        valid = idx >= 0
        sdf, grad = jfield.sdf_and_grad(p["decoder"], p["latents"][s],
                                        corpus["points"][s], idx, valid, x,
                                        cfg.rbf)
        has = jnp.any(valid, -1)
        n = jnp.maximum(jnp.sum(has), 1)
        sdf_loss = jnp.sum(jnp.where(has, jnp.abs(sdf - gt), 0.0)) / n
        safe = jnp.where(has[:, None], grad, jnp.asarray([1.0, 0.0, 0.0]))
        eik = jnp.sum(jnp.where(
            has, (jnp.linalg.norm(safe, axis=-1) - 1.0) ** 2, 0.0)) / n
        reg = jnp.mean(jnp.sum(p["latents"][s] ** 2, -1))
        return (sdf_loss + cfg.eikonal_weight * eik + cfg.latent_reg * reg,
                (sdf_loss, eik))

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def _grad_leaves(g):
    o = _ordered(g)
    return flatten(o)


def test_one_step_matches_jax(corpora):
    """One step at JAX's draws: the loss and its parts within 1e-5
    relative, every decoder and latent gradient within 1e-4 relative L2
    (f32 on both sides, sums and the double backward in another order;
    measured: 3.6e-7), and the parameters after the clipped two-group Adam
    (JAX's own window of one step) within 1e-6 absolute: the first Adam
    step is lr sign(g) where |g| >> eps, so a gradient's rounding moves an
    entry by at most lr times a relative error."""
    cfg_j, cfg_t, cj, spec_j, ct, spec_t = corpora
    key = jax.random.PRNGKey(5)
    pj = jpre.init_prior_params(jax.random.PRNGKey(0), cfg_j)
    s, qidx = _jax_draws(key, cfg_j)
    assert not jfield._use_fused()
    (lj, (sdf_j, eik_j)), gj = _jax_loss_and_grads(
        pj, cj, spec_j, cfg_j, s, jnp.asarray(qidx.numpy()))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.multi_transform(
        {"latents": optax.adam(cfg_j.latent_lr),
         "decoder": optax.adam(cfg_j.lr)},
        {"latents": "latents", "decoder": "decoder"}))
    window = jpre.make_prior_train_step(cfg_j, spec_j, tx)
    pj1, _, aux_j = window(pj, tx.init(pj), cj, key, 1)

    pt = params_from_numpy(_ordered(pj), "cpu")
    for leaf in flatten(pt):
        leaf.requires_grad_(True)
    lt, aux_t = tpre.prior_loss(pt, ct, spec_t, cfg_t, s, qidx)
    gt = torch.autograd.grad(lt, flatten(pt))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(aux_t["sdf_l1"].detach()),
                               float(sdf_j), rtol=1e-5)
    np.testing.assert_allclose(float(aux_t["eikonal"].detach()),
                               float(eik_j), rtol=1e-5)
    for a, b in zip(gt, _grad_leaves(gj)):
        assert np.abs(b).max() > 0
        assert _rel_err(a.numpy(), b) < 1e-4

    opt = tpre.PriorOptimizer(cfg_t)
    step = tpre.make_prior_train_step(cfg_t, spec_t, opt, device="cpu")
    aux = step(pt, opt.init(pt), ct, s=s, qidx=qidx)
    np.testing.assert_allclose(float(aux["loss"]), float(aux_j["loss"]),
                               rtol=1e-5)
    for a, b in zip(flatten(pt), flatten(_ordered(pj1))):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fused_agg", [False, True])
def test_jax_fused_path_trains_no_decoder(corpora, fused_agg):
    """The finding the port does not copy (ROADMAP Queue 3): on a TPU,
    ``sdf_and_grad`` takes the Pallas path -- K6a (``fused_agg`` False, a
    fresh process) or K3 (True) -- whose VJP returns zero cotangents for
    the frozen decoder, so JAX's pretraining gives F_geometry and T
    all-zero gradients there and only the latents learn.  In interpret
    mode (``set_fused_mlp("on")``, f32) the decoder gradient is exactly 0
    where the plain path's, which the port follows, is not; the latent
    gradients of the two paths agree within 1e-5 relative L2 (measured:
    7.8e-7; the decoder is piecewise linear, so the spatial gradient has
    no latent derivative almost everywhere, and the fused path's stopped
    gradient of the gradient costs the latents nothing)."""
    cfg_j, _, cj, spec_j, _, _ = corpora
    pj = jpre.init_prior_params(jax.random.PRNGKey(0), cfg_j)
    s, qidx = _jax_draws(jax.random.PRNGKey(5), cfg_j)
    q = jnp.asarray(qidx.numpy())
    _, g_plain = _jax_loss_and_grads(pj, cj, spec_j, cfg_j, s, q)
    with jax_field_state(fused_agg=fused_agg):
        _, g_fused = _jax_loss_and_grads(pj, cj, spec_j, cfg_j, s, q)
    for name in ("F_geometry", "T"):
        for lf, lp in zip(g_fused["decoder"][name], g_plain["decoder"][name]):
            for k in ("w", "b"):
                assert not np.asarray(lf[k]).any(), (name, k)
                assert np.abs(np.asarray(lp[k])).max() > 0, (name, k)
    lat_f = np.asarray(g_fused["latents"])
    lat_p = np.asarray(g_plain["latents"])
    assert np.abs(lat_f).max() > 0
    assert _rel_err(lat_f, lat_p) < 1e-5


# ---- save / load, the CLI, the Trainer ------------------------------------

def test_save_load_round_trip(tmp_path):
    """``save_prior`` writes the npz layout of ``PRIOR_ASSET``;
    ``load_prior`` reads the decoder back bit for bit and a ``Trainer``
    takes it through ``load_frozen``."""
    cfg = tpre.PriorConfig(**CFG)
    params = tpre.init_prior_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    path = str(tmp_path / "prior.npz")
    tpre.save_prior(path, params)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            [f"F_geometry.{i}.{k}" for i in range(5) for k in "wb"]
            + ["T.0.w", "T.0.b"])
    dec = tpre.load_prior(path, "cpu")
    for a, b in zip(flatten(dec), flatten(tpre.frozen_params(params))):
        assert torch.equal(a, b.detach())


def test_cli_pretrains_on_the_cpu_and_the_trainer_renders(tmp_path,
                                                          monkeypatch):
    """``python -m spurfies_tpu_torch.cli.pretrain_prior --device cpu``, a
    few steps on two shapes: the npz and the history are written (its
    default name is not the JAX package's ``artifacts/local_prior``), and
    the training CLI's prior loader and a ``Trainer`` take the result and
    render a chunk."""
    monkeypatch.chdir(tmp_path)
    assert cli_pretrain.DEFAULT_OUT != os.path.join("artifacts",
                                                    "local_prior")
    params, history = cli_pretrain.main(
        ["--steps", "3", "--shapes", "2", "--device", "cpu"])
    out = tmp_path / (cli_pretrain.DEFAULT_OUT + ".npz")
    assert out.exists()
    with open(tmp_path / (cli_pretrain.DEFAULT_OUT + "_history.json")) as f:
        hist = json.load(f)
    assert [r["step"] for r in hist] == [3] and np.isfinite(hist[0]["loss"])
    pts, cols, views = make_synthetic_scene(n_points=1500, img_res=(16, 16))
    cfg = t_apply(TConfig(), ["model.ray_sampler.n_samples_eval=32",
                              "model.ray_sampler.n_samples=32",
                              "model.max_shading_pts=32",
                              "train.eval_iters=1"])
    tr = Trainer(cfg, pts, cols, views, device="cpu",
                 compute_dtype=torch.float32)
    tr.load_frozen(tpre.load_prior(str(out), "cpu"))
    assert torch.equal(tr.frozen["T"][0]["w"],
                       params["decoder"]["T"][0]["w"].detach())
    img = tr.render_image(views["uv"], views["pose"][0],
                          views["intrinsics"][0])
    assert all(np.isfinite(v).all() for v in img.values())


def test_pretrain_learns_and_eval_holdout_runs():
    """``pretrain`` drives the SDF L1 down (JAX's ``test_pretrain_learns_sdf``,
    cut to 200 steps on two shapes), and ``eval_holdout`` on an unseen
    shape returns a finite L1.  Every step is logged (``log_every=1``) and
    the mean ``sdf_l1`` of the last 20 steps must lie below that of the
    first 20: one batch of 256 queries reads 0.012-0.025 at this size, so
    two single readings 20 steps apart order by chance."""
    cfg = tpre.PriorConfig(**dict(CFG, steps=200))
    params, history = tpre.pretrain(cfg, log_every=1, device="cpu")
    assert [r["step"] for r in history] == list(range(1, 201))
    l1 = np.array([r["sdf_l1"] for r in history])
    assert np.isfinite(l1).all()
    assert l1[-20:].mean() < l1[:20].mean()
    assert history[-1]["coverage"] > 0.3
    held = [tshapes.sample_shape(np.random.default_rng(3), n_query=512,
                                 spacing=0.04)]
    mean_l1, per = tpre.eval_holdout(params["decoder"], held, cfg,
                                     fit_steps=5, device="cpu")
    assert np.isfinite(mean_l1) and len(per) == 1
