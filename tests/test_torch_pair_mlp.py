"""K2 / K3 plain versions (and the field functions over them) against the
JAX package's fused Pallas path, run as its own tests run it on the CPU
(interpret mode, ``tests/test_pallas_mlp.py:289-303``), and against its
plain-XLA path.  Inputs are made with numpy and handed to both packages.

:func:`jax_field_state` is the one way the port's tests set the JAX field
module's switches; the other test files import it from here.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spurfies_tpu.config import ModelConfig
from spurfies_tpu.model import field as jfield
from spurfies_tpu.model.networks import init_model_params
from spurfies_tpu.ops import pallas_mlp as jpm
from spurfies_tpu_torch.convert.from_jax import params_from_numpy
from spurfies_tpu_torch.model import field as tfield
from spurfies_tpu_torch.ops import pair_mlp as tpm

M, K = 256, 8
N = M * K
RBF = 45.0


@pytest.fixture(scope="module")
def setup():
    params = init_model_params(jax.random.PRNGKey(1), ModelConfig())
    rng = np.random.default_rng(0)
    lat = (0.1 * rng.normal(size=(N, 32))).astype(np.float32)
    # each query's neighbours scattered around it at the query radius's
    # scale (weights far below f32's normal range would make "has a
    # neighbour" depend on denormal flushing, which XLA's CPU does)
    x = rng.uniform(-0.5, 0.5, (M, 3)).astype(np.float32)
    perm = rng.permutation(N)
    idx = perm.reshape(M, K).astype(np.int32)
    pts = np.empty((N, 3), np.float32)
    pts[perm] = np.repeat(x, K, 0) + rng.normal(0, 0.03, (N, 3))
    valid = rng.uniform(size=(M, K)) > 0.3
    valid[:5] = False                                   # empty points
    frozen_np = jax.tree_util.tree_map(np.asarray, params["frozen"])
    return params["frozen"], frozen_np, lat, pts, idx, valid, x


_FIELD_SWITCHES = ("FUSED_MLP_MODE", "FUSED_MLP_DTYPE", "FUSED_AGG",
                   "FUSED_AGG_R_DTYPE", "FUSED_COLOR")


@contextlib.contextmanager
def jax_field_state(fused_agg=True, dtype=jnp.float32, fused_color=False):
    """The JAX field module's Pallas path in interpret mode
    (``set_fused_mlp("on", dtype)``), ``set_fused_agg(fused_agg)`` (what
    the JAX ``Trainer`` sets from ``model.fused_agg``), f32 residuals and
    ``FUSED_COLOR = fused_color``; on exit the five switches get back the
    values they had on entry, so no later test on the same worker runs
    under this one's setting."""
    saved = [getattr(jfield, n) for n in _FIELD_SWITCHES]
    try:
        jfield.set_fused_mlp("on", dtype)
        jfield.set_fused_agg(fused_agg)
        jfield.FUSED_AGG_R_DTYPE = jnp.float32
        jfield.FUSED_COLOR = fused_color
        yield
    finally:
        for name, value in zip(_FIELD_SWITCHES, saved):
            setattr(jfield, name, value)


def jax_fused(fn, fused_agg=True, dtype=jnp.float32, fused_color=False):
    """``fn()`` under :func:`jax_field_state`."""
    with jax_field_state(fused_agg, dtype, fused_color):
        return fn()


def _torch_inputs(setup, compute_dtype):
    _, frozen_np, lat, pts, idx, valid, x = setup
    prior = tpm._prep_layers(params_from_numpy(frozen_np, "cpu"),
                             compute_dtype)
    table = tfield.pair_table(torch.from_numpy(lat), torch.from_numpy(pts))
    idx_ext = torch.from_numpy(np.where(valid, idx, N).astype(np.int32))
    return prior, table, idx_ext, torch.from_numpy(x)


def test_prep_layers_matches_jax(setup):
    frozen, _, *_ = setup
    ws_j, bs_j, n_act = jpm._prep_layers(frozen, jnp.float32)
    prior = _torch_inputs(setup, torch.float32)[0]
    assert prior.n_act == n_act == 4
    for a, b in zip(prior.ws + prior.bs, list(ws_j) + list(bs_j)):
        # the fused tail is an f32 product summed in another order
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_aggregate_plain_matches_fused_interpret_f32(setup):
    """K3 plain in f32 against the Pallas kernel in f32: same math, f32
    sums in another order -> ~1e-5 relative."""
    frozen, _, lat, pts, idx, valid, x = setup
    idx_ext = np.where(valid, idx, N).astype(np.int32)
    (num, den, gagg), (w_j, r_j, *_) = jax_fused(lambda: jfield._agg_fwd_impl(
        frozen, jnp.asarray(lat), jnp.asarray(pts), jnp.asarray(idx_ext),
        jnp.asarray(x), RBF))
    prior, table, t_idx, tx = _torch_inputs(setup, torch.float32)
    pt, w, r_lat = tpm.pair_sdf_aggregate(table, t_idx, tx, prior, RBF)
    for got, ref in ((pt[:, 0], num), (pt[:, 1], den), (pt[:, 2:], gagg),
                     (w, np.asarray(w_j)[:M * K, 0]),
                     (r_lat, np.asarray(r_j)[:M * K])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    assert r_lat.dtype == torch.float32


def test_value_agg_plain_matches_fused_interpret_f32(setup):
    frozen, _, lat, pts, idx, valid, x = setup
    idx_ext = np.where(valid, idx, N).astype(np.int32)
    sdf_j, has_j = jax_fused(lambda: jfield._aggregate_sdf_value_agg(
        frozen, jnp.asarray(lat), jnp.asarray(pts), jnp.asarray(idx_ext),
        jnp.asarray(x), RBF))
    prior, table, t_idx, tx = _torch_inputs(setup, torch.float32)
    pt = tpm.pair_sdf_value_agg(table, t_idx, tx, prior, RBF)
    has = pt[:, 1] > 0
    np.testing.assert_array_equal(has.numpy(), np.asarray(has_j))
    sdf = torch.where(has, pt[:, 0] / torch.where(has, pt[:, 1], 1.0), 1000.0)
    np.testing.assert_allclose(sdf.numpy(), np.asarray(sdf_j), rtol=1e-5,
                               atol=1e-6)


def test_plain_bf16_matches_fused_interpret_bf16(setup):
    """In bf16 the plain version rounds where the Pallas kernel rounds, so
    the two agree up to a bf16 rounding that the f32 sums' order moves by
    one ulp (2**-8): 99.5% of the points within 2**-6 relative + 1e-3 of
    the scale."""
    frozen, _, lat, pts, idx, valid, x = setup
    idx_ext = np.where(valid, idx, N).astype(np.int32)
    (num, den, gagg), _ = jax_fused(lambda: jfield._agg_fwd_impl(
        frozen, jnp.asarray(lat), jnp.asarray(pts), jnp.asarray(idx_ext),
        jnp.asarray(x), RBF), dtype=jnp.bfloat16)
    prior, table, t_idx, tx = _torch_inputs(setup, torch.bfloat16)
    pt, _, r_lat = tpm.pair_sdf_aggregate(table, t_idx, tx, prior, RBF)
    assert r_lat.dtype == torch.bfloat16
    for got, ref in ((pt[:, 0], num), (pt[:, 1], den), (pt[:, 2:], gagg)):
        ref = np.asarray(ref).reshape(M, -1)
        got = got.numpy().reshape(M, -1)
        d = np.abs(got - ref)
        tol = 2.0 ** -6 * np.abs(ref) + 1e-3 * np.abs(ref).max(0)
        assert (d > tol).mean() <= 0.005
        assert d.max() <= 0.05 * np.abs(ref).max()


def test_field_matches_jax_plain_xla_path(setup):
    """Against the JAX package's plain-XLA path (no fused tail, autodiff
    gradient) with test_pallas_mlp.py's own tolerances: the split first
    layer can flip a LeakyReLU gate on a kink row, so the gradient is held
    by the share of entries off by more than 1e-4 rel + 1e-5 (< 2%)."""
    frozen, frozen_np, lat, pts, idx, valid, x = setup
    s_ref, g_ref = jfield.sdf_and_grad(frozen, jnp.asarray(lat),
                                       jnp.asarray(pts), jnp.asarray(idx),
                                       jnp.asarray(valid), jnp.asarray(x),
                                       RBF)
    v_ref, has_ref = jfield.aggregate_sdf(
        frozen, jnp.asarray(lat), jnp.asarray(pts), jnp.asarray(idx),
        jnp.asarray(valid), jnp.asarray(x), RBF, need_grad=False)
    prior = tpm._prep_layers(params_from_numpy(frozen_np, "cpu"),
                             torch.float32)
    args = (torch.from_numpy(lat), torch.from_numpy(pts),
            torch.from_numpy(idx), torch.from_numpy(valid),
            torch.from_numpy(x), RBF)
    s, g = tfield.sdf_and_grad(prior, *args)
    v, has = tfield.aggregate_sdf(prior, *args, need_grad=False)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(has.numpy(), np.asarray(has_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-4,
                               atol=1e-5)
    gerr = np.abs(g.numpy() - np.asarray(g_ref))
    assert float((gerr > 1e-4 * np.abs(np.asarray(g_ref)) + 1e-5).mean()) \
        < 0.02


def test_pairs_outside_the_table_read_the_dump_row(setup):
    """An index outside [0, N] reads the dump row (w == 0), as N does; the
    kernels guard their table reads the same way."""
    prior, table, idx_ext, x = _torch_inputs(setup, torch.float32)
    bad = idx_ext.clone()
    bad[7, :3] = -2
    bad[8, :3] = N + 11
    dump = idx_ext.clone()
    dump[7, :3] = N
    dump[8, :3] = N
    for fn in (tpm.pair_sdf_value_agg, tpm.pair_sdf_aggregate):
        got, ref = fn(table, bad, x, prior, RBF), fn(table, dump, x, prior,
                                                     RBF)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(a, b)


def test_aggregate_is_forward_only(setup):
    """The raw K2/K3 wrappers carry no gradient, whatever their inputs
    require; the differentiable K3 is ``PairSdfAggregate``, whose backward
    is K4 (tests/test_torch_train_ops.py)."""
    prior, table, idx_ext, x = _torch_inputs(setup, torch.float32)
    table.requires_grad_()
    x.requires_grad_()
    pt, w, r_lat = tpm.pair_sdf_aggregate(table, idx_ext, x, prior, RBF)
    pv = tpm.pair_sdf_value_agg(table, idx_ext, x, prior, RBF)
    assert not any(t.requires_grad for t in (pt, w, r_lat, pv))


def test_kernel_buffers_need_bf16(setup):
    """The kernels' buffers: both refuse an f32 prior; ``k3_buffer()`` is
    bf16, 25 chunks of [256, 64], W0 [40, 256] and w_v; ``bias_buffer()``
    is b0..b3 and b_v in f32, 1,025 floats."""
    prior = _torch_inputs(setup, torch.float32)[0]
    for buffer in (prior.bias_buffer, prior.k3_buffer):
        with pytest.raises(ValueError, match="bf16"):
            buffer()
    prior = _torch_inputs(setup, torch.bfloat16)[0]
    wbuf, bbuf = prior.k3_buffer(), prior.bias_buffer()
    assert wbuf.dtype == torch.bfloat16
    assert wbuf.numel() == 25 * 256 * 64 + 40 * 256 + 256
    assert bbuf.dtype == torch.float32 and bbuf.numel() == 4 * 256 + 1
    assert torch.equal(bbuf, torch.cat([b.reshape(-1) for b in prior.bs]))


@pytest.mark.parametrize("kernel", ["value_agg", "aggregate"])
def test_dump_pairs_add_nothing_to_the_aggregate(setup, kernel):
    """The premise that lets K2's and K3's kernels skip the dump pairs
    (index outside [0, N)): in their plain versions those pairs' terms are
    +-0 (w == 0 exactly), so the per-point sums without them equal pt bit
    for bit, both in torch's own order and in the kernels' (j = 0..k-1 from
    +0), and a point with no real pair gets exactly 0; and (K3) K4 does not
    read their r_lat, whatever it holds."""
    prior, table, idx_ext, x = _torch_inputs(setup, torch.bfloat16)
    idx_ext = idx_ext.clone()
    idx_ext[7, :3] = -2
    idx_ext[8, 5:] = N + 11
    real = ((idx_ext >= 0) & (idx_ext < N)).reshape(-1)
    assert 0 < int(real.sum()) < M * K
    if kernel == "value_agg":
        cols = tpm.value_terms(table, idx_ext, x, prior, RBF)
        pt = tpm.pair_sdf_value_agg_ref(table, idx_ext, x, prior, RBF)
    else:
        cols, w, r_lat = tpm.aggregate_terms(table, idx_ext, x, prior, RBF)
        pt, w_ref, r_ref = tpm.pair_sdf_aggregate_ref(table, idx_ext, x,
                                                      prior, RBF)
        assert torch.equal(w, w_ref) and torch.equal(r_lat, r_ref)
    c = cols.shape[1]
    assert pt.shape == (M, c)
    assert bool((cols[~real, 1] == 0).all()) and bool((cols[~real] == 0).all())
    kept = torch.where(real[:, None], cols, 0.0)
    assert torch.equal(kept.view(M, K, c).sum(1), pt)
    empty = ~real.view(M, K).any(1)
    assert bool(empty.any()) and bool((pt[empty] == 0).all())
    seq_all = torch.zeros(M, c)
    seq_real = torch.zeros(M, c)
    c3, r3 = cols.view(M, K, c), real.view(M, K, 1)
    for j in range(K):
        seq_all = seq_all + c3[:, j]
        seq_real = torch.where(r3[:, j], seq_real + c3[:, j], seq_real)
    assert torch.equal(seq_all, seq_real)
    assert torch.equal(seq_real.view(torch.int32),
                       seq_all.view(torch.int32))
    if kernel == "value_agg":
        return
    # K4 drops the dump pairs: arbitrary finite r_lat there changes nothing
    num_bar = torch.from_numpy(
        np.random.default_rng(3).normal(size=M).astype(np.float32))
    noise = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1e3, (M * K, 32)).astype(np.float32)).to(r_lat.dtype)
    r_junk = torch.where(real[:, None], r_lat, noise)
    assert not torch.equal(r_junk, r_lat)
    assert torch.equal(
        tpm.pair_sdf_aggregate_bwd_ref(num_bar, w, r_lat, idx_ext, N),
        tpm.pair_sdf_aggregate_bwd_ref(num_bar, w, r_junk, idx_ext, N))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_value_agg_is_the_aggregates_first_two_columns(setup, dtype):
    """Plain K2's (sum w s, sum w) is plain K3's ``pt[:, :2]`` on the same
    inputs: the same gather, up sweep and tail (K3 only adds the down
    sweep), so the per-pair terms are bit-equal, and so are their sums in
    the kernels' order (j = 0..k-1 from +0).  torch's own ``sum(1)`` over
    the [P, k, 2] and [P, k, 5] terms runs in other orders: those two agree
    within the f32 sum-order limit 2 k 2**-24 sum|terms|.  The kernels are
    held bit-equal on the card (``tests/test_torch_cuda.py``,
    ``chip_smoke.py`` phase 4)."""
    prior, table, idx_ext, x = _torch_inputs(setup, dtype)
    idx_ext = idx_ext.clone()
    idx_ext[7, :3] = -2
    c2 = tpm.value_terms(table, idx_ext, x, prior, RBF)
    c3 = tpm.aggregate_terms(table, idx_ext, x, prior, RBF)[0]
    assert torch.equal(c2, c3[:, :2])
    seq2, seq3 = torch.zeros(M, 2), torch.zeros(M, 5)
    for j in range(K):
        seq2 = seq2 + c2.view(M, K, 2)[:, j]
        seq3 = seq3 + c3.view(M, K, 5)[:, j]
    assert torch.equal(seq2, seq3[:, :2])
    pt2 = tpm.pair_sdf_value_agg_ref(table, idx_ext, x, prior, RBF)
    pt3 = tpm.pair_sdf_aggregate_ref(table, idx_ext, x, prior, RBF)[0]
    assert pt2.shape == (M, 2) and bool((pt2[:, 1] > 0).any())
    limit = 2 * K * 2.0 ** -24 * c2.abs().view(M, K, 2).sum(1)
    assert bool(((pt2 - pt3[:, :2]).abs() <= limit).all())
    assert bool(((pt2 - seq2).abs() <= limit).all())


def _unswizzle(buf, rows, k):
    """``[rows, k]`` read back from blocks laid out as ``swz()`` of
    ``csrc/sdf_agg.cu`` addresses them: element (r, c) at
    ``(c // 64) rows 64 + 64 r + ((c % 64) // 8 ^ r % 8) 8 + c % 8``."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(k)[None, :]
    off = (c // 64) * rows * 64 + r * 64 + \
        (((c % 64) // 8) ^ (r % 8)) * 8 + c % 8
    return buf[off]


def test_k3_buffer_unpacks_to_the_prior_layers(setup):
    """K3's weight buffer holds every layer of ``PriorLayers.ws`` exactly,
    in the chunk order the kernel streams them."""
    with pytest.raises(ValueError, match="bf16"):
        _torch_inputs(setup, torch.float32)[0].k3_buffer()
    prior = _torch_inputs(setup, torch.bfloat16)[0]
    buf = prior.k3_buffer()
    ch = 256 * 64
    assert buf.dtype == torch.bfloat16
    assert buf.numel() == 25 * ch + 40 * 256 + 256
    assert prior.k3_buffer() is buf                  # packed once
    ws = prior.ws
    up0 = _unswizzle(buf[:ch], 256, 64)
    assert torch.equal(up0[:, :35], ws[0].t()) and bool((up0[:, 35:] == 0).all())
    for n, l in enumerate((1, 2, 3)):
        got = _unswizzle(buf[(1 + 4 * n) * ch:(5 + 4 * n) * ch], 256, 256)
        assert torch.equal(got, ws[l].t())
    for n, l in enumerate((3, 2, 1)):
        got = _unswizzle(buf[(13 + 4 * n) * ch:(17 + 4 * n) * ch], 256, 256)
        assert torch.equal(got, ws[l])
    dn0 = _unswizzle(buf[25 * ch:25 * ch + 40 * 256], 40, 256)
    assert torch.equal(dn0[:35], ws[0]) and bool((dn0[35:] == 0).all())
    assert torch.equal(buf[25 * ch + 40 * 256:], ws[4].reshape(-1))


def test_k3_buffer_up_sweep_gives_the_value_agg(setup):
    """K2's kernel reads only chunks 0-12 of ``k3_buffer()`` (W0^T, then
    W1-3^T) and w_v at its offset, with ``bias_buffer()``'s f32 biases:
    the prior rebuilt from exactly those bytes, unswizzled with the
    kernel's address formula, gives plain K2's pt bit for bit."""
    prior, table, idx_ext, x = _torch_inputs(setup, torch.bfloat16)
    buf = prior.k3_buffer()
    bbuf = prior.bias_buffer()
    ch = 256 * 64
    wv_off = 25 * ch + 40 * 256                    # kWvOff, in elements
    ws = [_unswizzle(buf[:ch], 256, 64)[:, :35].t()]
    ws += [_unswizzle(buf[(1 + 4 * n) * ch:(5 + 4 * n) * ch], 256, 256).t()
           for n in range(3)]
    ws.append(buf[wv_off:wv_off + 256].reshape(256, 1))
    bs = [bbuf[256 * l:256 * (l + 1)][None] for l in range(4)]
    bs.append(bbuf[4 * 256:][None])
    rebuilt = tpm.PriorLayers(ws, bs, 4, torch.bfloat16)
    for a, b in zip(rebuilt.ws + rebuilt.bs, prior.ws + prior.bs):
        assert a.shape == b.shape
    assert torch.equal(
        tpm.pair_sdf_value_agg_ref(table, idx_ext, x, rebuilt, RBF),
        tpm.pair_sdf_value_agg_ref(table, idx_ext, x, prior, RBF))
