"""The DUSt3R network (``spurfies_tpu_torch/prep/dust3r_net.py``) against
the JAX package's, on the CPU at ``tests/test_dust3r_net.py``'s ``TINY``
config (64x64 images, encoder 64 x 2, decoder 32 x 2).

Both packages get the same weights: the JAX tree of ``init_dust3r``
through ``convert.from_jax.dust3r_from_jax``, or one synthetic state dict
in the upstream key layout through each package's ``convert_dust3r``.
Each block and the whole pair are held within 1e-5 of the output's scale
(f32 on both sides; the sum orders differ).
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spurfies_tpu.prep import dust3r_net as jd
from spurfies_tpu_torch.convert.from_jax import dust3r_from_jax
from spurfies_tpu_torch.prep import dust3r_net as td

TINY_J = jd.Dust3rConfig(img_size=(64, 64), patch=16, enc_dim=64,
                         enc_depth=2, enc_heads=4, dec_dim=32, dec_depth=2,
                         dec_heads=2)
TINY = td.Dust3rConfig(img_size=(64, 64), patch=16, enc_dim=64,
                       enc_depth=2, enc_heads=4, dec_dim=32, dec_depth=2,
                       dec_heads=2)
TOL = 1e-5


def _close(ours, ref, tol=TOL):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, the port's tree of tensors) of one ``init_dust3r``."""
    jt = jax.tree.map(np.asarray, jd.init_dust3r(jax.random.PRNGKey(0),
                                                 TINY_J))
    # ln weights away from 1/0 so that a swapped gain or bias shows
    rng = np.random.default_rng(7)

    def perturb(tree):
        if isinstance(tree, list):
            return [perturb(v) for v in tree]
        if "g" in tree and not isinstance(tree["g"], dict):
            return {"g": (tree["g"] + rng.uniform(-0.3, 0.3, tree["g"].shape)
                          ).astype(np.float32),
                    "b": rng.uniform(-0.2, 0.2, tree["b"].shape)
                    .astype(np.float32)}
        if "w" in tree and not isinstance(tree["w"], dict):
            return tree
        return {k: perturb(v) for k, v in tree.items()}

    jt = perturb(jt)
    return jt, td.Dust3rNet(dust3r_from_jax(jt), TINY).params


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pos(n, seed=1):
    return np.random.default_rng(seed).integers(0, 12, (n, 2)).astype(
        np.float32)


def test_rope2d_angles_is_jax():
    pos = _pos(20)
    for hd in (8, 16, 64):
        jc, js = jd.rope2d_angles(jnp.asarray(pos), hd, 100.0)
        tc, ts = td.rope2d_angles(torch.from_numpy(pos), hd, 100.0)
        _close(tc, jc)
        _close(ts, js)


def test_apply_rope_is_jax():
    """Interleaved pairs (x[2i], x[2i+1]), y on the first half of the
    pairs, x on the second."""
    x, pos = _x((4, 20, 16)), _pos(20)
    jc, js = jd.rope2d_angles(jnp.asarray(pos), 16)
    tc, ts = td.rope2d_angles(torch.from_numpy(pos), 16)
    _close(td.apply_rope(torch.from_numpy(x), tc, ts),
           jd.apply_rope(jnp.asarray(x), jc, js))


def test_layer_norm_is_jax(weights):
    jt, tt = weights
    x = _x((9, 64)) * 3 + 1
    _close(td.layer_norm(tt["enc_blocks"][0]["ln1"], torch.from_numpy(x)),
           jd.layer_norm(jt["enc_blocks"][0]["ln1"], jnp.asarray(x)))


@pytest.mark.parametrize("rope", [False, True])
def test_attention_is_jax(weights, rope):
    """Cross-attention of 16 queries on 12 keys, with and without RoPE on
    q and k."""
    jt, tt = weights
    xq, xk = _x((16, 32), 2), _x((12, 32), 3)
    jr = tr = (None, None)
    if rope:
        pq, pk = _pos(16, 4), _pos(12, 5)
        jr = (jd.rope2d_angles(jnp.asarray(pq), 16),
              jd.rope2d_angles(jnp.asarray(pk), 16))
        tr = (td.rope2d_angles(torch.from_numpy(pq), 16),
              td.rope2d_angles(torch.from_numpy(pk), 16))
    _close(td.attention(tt["dec_blocks"][1]["cross"], torch.from_numpy(xq),
                        torch.from_numpy(xk), 2, *tr),
           jd.attention(jt["dec_blocks"][1]["cross"], jnp.asarray(xq),
                        jnp.asarray(xk), 2, *jr))


def test_enc_block_is_jax(weights):
    jt, tt = weights
    x, pos = _x((16, 64)), _pos(16)
    jr = jd.rope2d_angles(jnp.asarray(pos), 16)
    tr = td.rope2d_angles(torch.from_numpy(pos), 16)
    _close(td.enc_block(tt["enc_blocks"][1], torch.from_numpy(x), tr, 4),
           jd.enc_block(jt["enc_blocks"][1], jnp.asarray(x), jr, 4))


def test_dec_block_is_jax(weights):
    """The self-attention, the cross-attention (``ln_cross`` on x,
    ``ln_ctx`` on the context) and the MLP of one decoder block."""
    jt, tt = weights
    x, ctx, pos = _x((16, 32), 6), _x((16, 32), 7), _pos(16)
    jr = jd.rope2d_angles(jnp.asarray(pos), 16)
    tr = td.rope2d_angles(torch.from_numpy(pos), 16)
    _close(td.dec_block(tt["dec_blocks2"][0], torch.from_numpy(x),
                        torch.from_numpy(ctx), tr, tr, 2),
           jd.dec_block(jt["dec_blocks2"][0], jnp.asarray(x),
                        jnp.asarray(ctx), jr, jr, 2))


def test_patchify_is_jax(weights):
    """The HWIO conv on NHWC (JAX) against the OIHW conv on NCHW."""
    jt, tt = weights
    img = np.random.default_rng(8).uniform(-1, 1, (64, 64, 3)).astype(
        np.float32)
    _close(td.patchify(tt, torch.from_numpy(img), TINY),
           jd.patchify(jt, jnp.asarray(img), TINY_J))


def _images():
    rng = np.random.default_rng(9)
    return [rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32)
            for _ in range(2)]


def _hold_pair(out_t, out_j):
    assert set(out_t) == set(out_j) == {"pts1", "conf1", "pts2", "conf2"}
    for k in out_j:
        _close(out_t[k], out_j[k])


def test_infer_pair_is_jax(weights):
    """The four outputs of a pair (head layout ``(py, px, c)``, the exp-mode
    postprocess), each within 1e-5 of its scale; the port's are plain
    tensors made under ``inference_mode``."""
    jt, tt = weights
    a, b = _images()
    out_t = td.infer_pair(tt, torch.from_numpy(a), torch.from_numpy(b),
                          TINY)
    _hold_pair(out_t, jd.infer_pair(jt, jnp.asarray(a), jnp.asarray(b),
                                    TINY_J))
    assert out_t["pts1"].is_inference()
    assert float(out_t["conf1"].min()) >= 1.0


def test_convert_dust3r_is_jax():
    """One synthetic state dict in the upstream key layout through both
    converters: the same outputs; every key is read."""
    state = td.random_dust3r_state(TINY, seed=3)
    read = set()

    class Tracked(dict):
        def __getitem__(self, k):
            read.add(k)
            return dict.__getitem__(self, k)

    net = td.convert_dust3r({"model": Tracked(state["model"])}, TINY)
    assert read == set(state["model"])
    a, b = _images()
    _hold_pair(net(torch.from_numpy(a), torch.from_numpy(b)),
               jd.infer_pair(jd.convert_dust3r(state, TINY_J),
                             jnp.asarray(a), jnp.asarray(b), TINY_J))


def test_bf16_state_loads(tmp_path):
    """A bf16 (or f16) checkpoint file converts: its weights are read as
    f32, the same network as the f32 copy of those values."""
    state = td.random_dust3r_state(TINY, seed=4, dtype=torch.bfloat16)
    path = str(tmp_path / "dust3r_bf16.pth")
    torch.save(state, path)
    net = td.convert_dust3r(path, TINY)
    ref = td.convert_dust3r({k: v.float() for k, v in
                             state["model"].items()}, TINY)
    for k, v in net.state_dict().items():
        assert v.dtype == torch.float32
        assert torch.equal(v, ref.state_dict()[k])
    half = td.convert_dust3r(td.random_dust3r_state(TINY, seed=4,
                                                    dtype=torch.float16),
                             TINY)
    a, b = _images()
    out = half(torch.from_numpy(a), torch.from_numpy(b))
    assert all(torch.isfinite(v).all() for v in out.values())
