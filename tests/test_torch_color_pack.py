"""The colour kernels' pieces on the CPU: the packed weights of
``ops/fused_color.pack_color_weights``, the plain halves the kernels split
the forward into (against ``fused_color_fwd_ref`` and the JAX package's
``_fwd_body``, ``spurfies_tpu/ops/pallas_color.py:54``), and the plain
reverse pieces and split-K dW product of K8b (against
``fused_color_bwd_ref``).

Weights and inputs are made with numpy from a seed: ModelConfig's colour
nets (F_color 103 -> 256 x 4, R 277 -> 256 -> 256 -> 3), 128 points of 8
pair rows, 30 % of the slots invalid (wn = 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spurfies_tpu.ops import pallas_color as jpc
from spurfies_tpu_torch.ops import fused_color as fc

P = 128                 # the JAX body's tile: _fwd_body reshapes to 128
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _nets(seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for shapes in (fc.F_SHAPES, fc.R_SHAPES):
        out.append([{"w": rng.normal(0, 1 / np.sqrt(i), (i, o)).astype(
            np.float32), "b": rng.normal(0, 0.1, o).astype(np.float32)}
            for i, o in shapes])
    return out


def _inputs(seed=9):
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(P, 8)) > 0.3
    x_pi = rng.normal(0, 0.03, (P, 8, 3))
    x_pi[~valid] = rng.uniform(-1, 1, (int((~valid).sum()), 3))
    w = rng.uniform(0.05, 1.0, (P, 8)) * valid
    den = w.sum(1, keepdims=True)
    dirs = rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    enc = [dirs] + [f(dirs * 2.0 ** i) for i in range(3)
                    for f in (np.sin, np.cos)]
    return [a.astype(np.float32) for a in (
        x_pi.reshape(-1, 3), rng.normal(0, 0.3, (P * 8, 64)),
        (w / np.where(den > 0, den, 1.0)).reshape(-1),
        np.concatenate(enc, -1))]


def _torch_nets(nets):
    return [[{k: torch.from_numpy(v) for k, v in layer.items()}
             for layer in net] for net in nets]


def _unswizzle(buf, rows, k):
    """``[rows, k]`` read back from 64-column blocks of ``rows`` rows as
    ``wg::swz`` and ``pack_kernel`` of ``csrc/color_mlp.cu`` lay them out:
    element (r, c) at ``(c // 64) rows 64 + 64 r + ((c % 64) // 8 ^ r % 8)
    8 + c % 8``."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(k)[None, :]
    off = (c // 64) * rows * 64 + r * 64 + \
        (((c % 64) // 8) ^ (r % 8)) * 8 + c % 8
    return buf[off]


def test_pack_unpacks_to_the_layers():
    """Every image of the pack is bf16(W^T) (forward) or bf16(W) from its
    first row (reverse), zero-padded, in the chunk the kernels stream; the
    rest of the buffer is zero."""
    f_color, r = _torch_nets(_nets())
    ws = [layer["w"] for layer in f_color + r]
    buf = fc.pack_color_weights(f_color, r)
    assert buf.dtype == torch.bfloat16
    assert buf.numel() == fc.PACK_CHUNKS * fc.PACK_CHUNK
    used = torch.zeros(buf.numel(), dtype=torch.bool)
    seen = set()
    for chunk, layer, trans, rows, cols, row0 in fc.PACK:
        at = chunk * fc.PACK_CHUNK
        got = _unswizzle(buf[at:at + rows * cols], rows, cols)
        want = ws[layer].t() if trans else ws[layer][row0:row0 + rows]
        h, w = want.shape
        assert torch.equal(got[:h, :w], want.to(torch.bfloat16)), chunk
        assert bool((got[h:] == 0).all()) and bool((got[:, w:] == 0).all())
        used[at:at + rows * cols] = True
        seen.add((layer, trans))
    assert seen == {(i, t) for i in range(7) for t in (True, False)}
    assert bool((buf[~used] == 0).all())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_halves_compose_to_the_forward(dt):
    """The pair half (F_color, the wn-sum, g) then the point half (R, the
    sigmoid) is the plain K8a bit for bit: the kernels split the stack at
    g, which the TPU body already rounds."""
    f_color, r = _torch_nets(_nets())
    ins = [torch.from_numpy(a) for a in _inputs()]
    tdt = DT[dt][1]
    g, _ = fc.pair_half_ref(*ins, f_color, tdt)
    rgb, _ = fc.point_half_ref(g, r, tdt)
    assert g.shape == (P, 277) and g.dtype == tdt
    assert torch.equal(rgb, fc.fused_color_fwd_ref(*ins, f_color, r, tdt))


def test_pair_half_matches_the_jax_body():
    """The pair half's g against ``_fwd_body``'s first R input (``r_in[0]``)
    and the point half's rgb against its rgb, in f32 (the same products,
    f32 sums in another order: rtol 1e-5)."""
    nets = _nets()
    ins = _inputs()
    fws = [jnp.asarray(l["w"]) for l in nets[0]]
    fbs = [jnp.asarray(l["b"])[None] for l in nets[0]]
    rws = [jnp.asarray(l["w"]) for l in nets[1]]
    rbs = [jnp.asarray(l["b"])[None] for l in nets[1]]
    x_pi, lat, wn, de = (jnp.asarray(a) for a in ins)
    rgb_j, res = jpc._fwd_body(x_pi, lat, wn[:, None], de, fws, fbs, rws, rbs,
                               jnp.float32)
    f_color, r = _torch_nets(nets)
    g, _ = fc.pair_half_ref(*[torch.from_numpy(a) for a in ins], f_color,
                            torch.float32)
    rgb, _ = fc.point_half_ref(g, r, torch.float32)
    np.testing.assert_allclose(g.numpy(), np.asarray(res[5][0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=1e-5,
                               atol=1e-6)


def test_pack_checks_its_weights():
    f_color, r = _torch_nets(_nets())
    with pytest.raises(ValueError, match="layers"):
        fc.pack_color_weights(f_color[:3], r)
    bad = [dict(layer) for layer in f_color]
    bad[1]["w"] = bad[1]["w"].double()
    with pytest.raises(ValueError, match="f32"):
        fc.pack_color_weights(bad, r)


def _sum_order_close(got, want, abs_sum, count):
    """Two f32 sums of the same ``count`` terms in two orders lie within
    2 count 2**-24 sum|terms| of each other."""
    assert bool(((got - want).abs() <= 2 * count * 2.0 ** -24 * abs_sum
                 + 1e-30).all())


@pytest.mark.parametrize("splits", [1, 3, 64])
def test_split_k_dw_is_the_product(splits):
    """The dW kernel's plain version: the rows in ``splits`` ranges of whole
    32-row chunks, each range's product then the ranges in order, is
    ``_mm(X^T, delta)``: bit for bit with one range, else within the f32
    sum-order limit (the kernel takes up to 64 ranges)."""
    rng = np.random.default_rng(splits)
    x = torch.from_numpy(rng.normal(size=(1000, 96)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(1000, 40)).astype(np.float32))
    dt = torch.bfloat16
    got = fc.dw_split_ref(x, d, splits, dt)
    want = fc._mm(x.t(), d, dt)
    if splits == 1:
        assert torch.equal(got, want)
    abs_sum = fc._mm(x.abs().t(), d.abs(), dt)
    _sum_order_close(got, want, abs_sum, x.shape[0])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_reverse_pieces_compose_to_the_backward(dt):
    """The kernels' pieces of K8b, composed (the pair half, the point
    kernel's forward and reverse, the reverse pair kernel, then each dW as
    the split-K product over 3 row ranges and each db as a column sum),
    give the plain K8b: dlat and db bit for bit, dW within the f32
    sum-order limit."""
    f_color, r = _torch_nets(_nets())
    ins = [torch.from_numpy(a) for a in _inputs()]
    rgb_bar = torch.from_numpy(np.random.default_rng(2).normal(
        size=(P, 3)).astype(np.float32))
    tdt = DT[dt][1]
    g, (fw_in, f_pre) = fc.pair_half_ref(*ins, f_color, tdt)
    d_agg, r_in, r_deltas = fc.point_bwd_ref(g, r, rgb_bar, tdt)
    dlat, f_deltas = fc.pair_bwd_ref(d_agg, ins[2], f_color, f_pre, tdt)
    ref_dlat, ref_dws, ref_dbs = fc.fused_color_bwd_ref(*ins, f_color, r,
                                                        rgb_bar, tdt)
    assert torch.equal(dlat, ref_dlat)
    assert bool((dlat[ins[2] == 0] == 0).all())
    for x, d, want_w, want_b in zip(fw_in + r_in, f_deltas + r_deltas,
                                    ref_dws, ref_dbs):
        got = fc.dw_split_ref(x, d, 3, tdt)
        assert got.shape == want_w.shape
        _sum_order_close(got, want_w, fc._mm(x.abs().t(), d.abs(), tdt),
                         x.shape[0])
        assert torch.equal(d.sum(0), want_b)
