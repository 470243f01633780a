"""The premises of K1 exact's and K4's kernels, on the CPU.

K1 exact selects, like K1 packed, with a group of G lanes per query: lane
l takes the candidates l, l + G, ..., keeps its own k smallest keys in
order, and the group takes k rounds of a minimum over the lanes' heads.
Its key is 64 bits: high word the f32 bits of d2 (monotone for d2 >= +0),
low word 0xFFFFFFFF - id, so that on a d2 tie the larger id comes first.
Keys are distinct within a list (ids are unique there), so any way of
taking the k smallest gives the same keys in the same order.
:func:`group_select_exact` models the kernel so in torch; it is held
against the plain version and against the TPU kernel in interpret mode, on
ids up to 2**31 - 32768, exact d2 ties (candidates at one position), lists
of 0, 1, k - 1, k and qcap candidates, a qcap below k, cells outside the
grid and lists the radius cuts short of k.

K4 walks the pair rows 32 at a time, a warp a window: a ballot marks the
window's kept rows (index in [0, n) and w != 0), which go 4 at a time to
the warp's four groups of 8 lanes, lane l adding the columns 4 l .. 4 l + 3
of ``(num_bar * w) * r_lat`` with one 4-wide atomic.  :func:`k4_model`
does the same adds in torch, in a random order (the atomics' order is no
one's), and is held to the plain version and to the TPU kernel in
interpret mode within the f32 sum-order limit; it adds every column of a
kept row once and reads nothing of a dropped row's r_lat.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_k7_k1_premises import K, _lists

from spurfies_tpu.ops import pallas_mlp as jpm
from spurfies_tpu.ops.pallas_select import select_knn_pallas
from spurfies_tpu_torch.ops import pair_mlp as tpm
from spurfies_tpu_torch.ops import select_knn as sk

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# The kernel's sentinel is all ones in uint64 order.  Every real key lies
# below 2**63 (d2 is finite and >= +0, so its bits are below 2**31), so in
# int64 the model takes 2**63 - 1 for it: above every key, as in the kernel.
_SENTINEL = torch.iinfo(torch.int64).max
_LOW = 0xFFFFFFFF


def exact_keys(x, cid, qidx, qpos, radius2):
    """The exact kernel's key of each (query, candidate): ``[M, Q]`` int64,
    the sentinel where the candidate is empty or outside the radius."""
    in_grid = (cid >= 0) & (cid < qidx.shape[0])
    c = torch.where(in_grid, cid, 0).long()
    cand = torch.where(in_grid[:, None], qidx[c], -1)
    diff = qpos[c] - x[:, :, None]
    d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) \
        + diff[:, 2] * diff[:, 2]
    ok = (cand >= 0) & (d2 <= radius2)
    key = (d2.view(torch.int32).long() << 32) | (_LOW - cand.long())
    return torch.where(ok, key, _SENTINEL)


def group_select_exact(x, cid, qidx, qpos, radius2, k, group):
    """``csrc/select_knn.cu``'s ``select_kernel<ExactKey, k, group>`` in
    torch: lane l of a query's group keeps the k smallest keys of its
    candidates t = l, l + group, ... (in order), then k rounds take the
    minimum of the lanes' heads and advance the lane that owns it."""
    key = exact_keys(x, cid, qidx, qpos, radius2)
    m, q = key.shape
    pad = (-q) % group
    key = torch.cat([key, key.new_full((m, pad), _SENTINEL)], 1)
    lanes = key.view(m, -1, group).transpose(1, 2)
    lanes = lanes.sort(2).values[:, :, :k]
    lanes = torch.cat([lanes, lanes.new_full((m, group, 1), _SENTINEL)], 2)
    head = torch.zeros((m, group), dtype=torch.long)
    out = []
    for _ in range(k):
        heads = torch.gather(lanes, 2, head[:, :, None])[:, :, 0]
        best, owner = heads.min(1)
        out.append(best)
        head[torch.arange(m), owner] += (best < _SENTINEL).long()
    keys = torch.stack(out, 1)
    valid = keys < _SENTINEL
    idx = torch.where(valid, _LOW - (keys & _LOW), -1).to(torch.int32)
    d2 = torch.where(valid, (keys >> 32).to(torch.int32).view(torch.float32),
                     float("inf"))
    return idx, d2


def _exact_lists(q, m, seed):
    """``_lists``' table with its ids spread to 65537 id (unique, up to
    2**31 - 32768; id 0 stays, whose low word is all ones) and, in every
    cell of 2 or more candidates, the second candidate moved onto the
    first: exact d2 ties between distinct ids."""
    x, cid, qidx, qpos = _lists(q, m, seed)
    qidx = torch.where(qidx >= 0, qidx * 65537, -1)
    qidx[0, :1] = torch.where(qidx[0, :1] >= 0, 0, -1)
    qpos = qpos.clone()
    two = (qidx[:, 1] >= 0).nonzero()[:, 0]
    qpos[two, :, 1] = qpos[two, :, 0]
    return x, cid, qidx, qpos


@pytest.mark.parametrize("q", [128, 20, 4], ids=["qcap128", "qcap20", "q<k"])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
def test_group_select_is_the_plain_exact_select(q, group):
    """The 64-bit-key lane-group model against
    ``select_knn_ref(packed=False)``: ids and d2 bit-equal for any group
    size, with ties, large ids and lists the radius cuts short of k."""
    x, cid, qidx, qpos = _exact_lists(q, 1001, seed=q + 1)
    r2 = float(np.float32(0.04 ** 2))
    gi, gd = group_select_exact(x, cid, qidx, qpos, r2, K, group)
    ri, rd = sk.select_knn_ref(x, cid, qidx, qpos, r2, K, packed=False)
    assert torch.equal(gi, ri) and torch.equal(gd, rd)
    # the inputs hold what the test says they hold
    in_grid = (cid >= 0) & (cid < qidx.shape[0])
    assert bool((gi[~in_grid] == -1).all()) and bool((~in_grid).any())
    assert int(gi.max()) >= 2 ** 30
    found = (gi >= 0).sum(1)
    length = torch.where(in_grid, (qidx[cid.clamp(0, qidx.shape[0] - 1)]
                                   >= 0).sum(1), 0)
    assert bool((found < length.clamp(max=K)).any())
    assert bool((found == min(K, q)).any())
    tie = (gd[:, 1:] == gd[:, :-1]) & torch.isfinite(gd[:, 1:])
    assert bool(tie.any())
    assert bool((gi[:, :-1][tie] > gi[:, 1:][tie]).all())


@pytest.mark.parametrize("q", [128, 4], ids=["qcap128", "q<k"])
def test_group_select_is_the_pallas_exact_select(q):
    """The lane-group model (the kernel's group size) against the TPU
    kernel in interpret mode on the same gathered candidates, held as
    ``tests/test_torch_select_knn.py`` holds the plain version to it: ids
    bit-equal, the same slots empty, d2 within 2 ulp: XLA's CPU may fuse
    the interpreted kernel's ``d2 + diff * diff`` into one rounding, for
    each of its two sums (it reads 2 ulp on these lists).  The model's d2
    is the plain version's bit for bit, by the test above."""
    x, cid, qidx, qpos = _exact_lists(q, 1001, seed=200 + q)
    r2 = float(np.float32(0.04 ** 2))
    in_grid = (cid >= 0) & (cid < qidx.shape[0])
    c = torch.where(in_grid, cid, 0).long()
    cand = torch.where(in_grid[:, None], qidx[c], -1)
    pi, pd = select_knn_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(cand.numpy()),
        jnp.asarray(qpos[c].numpy()), k=K, radius2=r2, tile=512,
        interpret=True, packed=False)
    gi, gd = group_select_exact(x, cid, qidx, qpos, r2, K, sk.EXACT_GROUP)
    pi, pd = np.asarray(pi), np.asarray(pd)
    np.testing.assert_array_equal(gi.numpy(), pi)
    fin = np.isfinite(pd)
    np.testing.assert_array_equal(np.isfinite(gd.numpy()), fin)
    assert np.all(np.abs(gd.numpy()[fin] - pd[fin])
                  <= 2 * np.spacing(np.abs(pd[fin])))
    tie = (pd[:, 1:] == pd[:, :-1]) & fin[:, 1:]
    assert tie.any() and (pi[:, :-1][tie] > pi[:, 1:][tie]).all()


# -------------------------------------------------------------- K4 ----

def k4_model(num_bar, w, r_lat, idx_ext, n, seed):
    """``csrc/agg_bwd.cu``'s adds in torch.  Returns (out ``[n, 32]`` f32,
    the number of adds each (row, column) took ``[rows, 32]``).  Windows of
    32 rows; each window's kept rows in fours, row j of a four to lane
    group j, whose lane l takes columns 4 l .. 4 l + 3; the 4-wide adds
    land in a random order (seeded), each summed in f32."""
    rows, k = w.numel(), idx_ext.shape[1]
    flat = idx_ext.reshape(-1)
    keep = (flat >= 0) & (flat < n) & (w != 0)
    adds = []                                   # (row, first column)
    for base in range(0, rows, 32):
        kept = (keep[base:base + 32].nonzero()[:, 0] + base).tolist()
        for j in range(0, len(kept), 4):
            for row in kept[j:j + 4]:           # one lane group each
                adds += [(row, 4 * lane) for lane in range(8)]
    order = np.random.default_rng(seed).permutation(len(adds))
    out = torch.zeros((n, 32), dtype=torch.float32)
    took = torch.zeros((rows, 32), dtype=torch.int32)
    for a in order:
        row, c = adds[a]
        sw = num_bar[row // k] * w[row]          # f32, rounded once
        v = sw * r_lat[row, c:c + 4].float()     # (num_bar w) r, rounded
        out[flat[row], c:c + 4] += v
        took[row, c:c + 4] += 1
    return out, took


def _k4_inputs(p=201, n=97, seed=6):
    """K3-shaped residuals in bf16: about half the rows dump rows (index n,
    w 0), a few w == 0 rows on real indices, a tenth of the kept rows on
    one latent row; p * 8 rows, no whole number of 32-row windows."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (p, 8)).astype(np.int32)
    dump = rng.uniform(size=(p, 8)) < 0.5
    idx[dump] = n
    idx[~dump & (rng.uniform(size=(p, 8)) < 0.1)] = 5
    w = np.where(dump, 0.0, rng.uniform(0.0, 1.0, (p, 8))).astype(np.float32)
    w[~dump & (rng.uniform(size=(p, 8)) < 0.02)] = 0.0
    r = torch.from_numpy(rng.normal(0, 0.1, (p * 8, 32)).astype(np.float32))
    return (torch.from_numpy(rng.normal(size=p).astype(np.float32)),
            torch.from_numpy(w.reshape(-1)), r.to(torch.bfloat16),
            torch.from_numpy(idx), n)


def _k4_limit_args(num_bar, w, r_lat, idx_ext, n):
    """``sum_order_within``'s scatter of |terms| and term counts."""
    flat = idx_ext.reshape(-1).long()
    keep = (flat >= 0) & (flat < n) & (w != 0)
    return (tpm.pair_sdf_aggregate_bwd_ref(num_bar.abs(), w.abs(),
                                           r_lat.abs(), idx_ext, n),
            torch.bincount(flat[keep], minlength=n))


@pytest.mark.parametrize("seed", [0, 1])
def test_k4_model_is_the_plain_aggregate_bwd(seed):
    """The window model against ``pair_sdf_aggregate_bwd_ref`` within the
    f32 sum-order limit; every column of a kept row added once, nothing of
    a dropped row."""
    args = _k4_inputs(seed=6 + seed)
    num_bar, w, r_lat, idx_ext, n = args
    out, took = k4_model(*args, seed=seed)
    ref = tpm.pair_sdf_aggregate_bwd_ref(*args)
    smoke.sum_order_within("K4 model", out, ref, *_k4_limit_args(*args))
    flat = idx_ext.reshape(-1)
    keep = (flat >= 0) & (flat < n) & (w != 0)
    assert bool((took[keep] == 1).all()) and bool((took[~keep] == 0).all())
    assert bool((~keep & (flat == n)).any()) and bool(
        (~keep & (flat < n)).any())                    # both kinds dropped
    assert w.numel() % 32 != 0


def test_k4_model_is_the_pallas_aggregate_bwd():
    """The window model against ``_fused_agg_bwd_call(..., interpret=True)``
    (as ``tests/test_torch_train_ops.py`` runs the plain version against
    it) within the f32 sum-order limit."""
    args = _k4_inputs(p=256, seed=9)
    num_bar, w, r_lat, idx_ext, n = args
    k = idx_ext.shape[1]
    ref = np.asarray(jpm._fused_agg_bwd_call(
        jnp.asarray(num_bar.numpy())[:, None], jnp.asarray(w.numpy())[:, None],
        jnp.asarray(r_lat.float().numpy()),
        jnp.asarray(idx_ext.reshape(-1).numpy()), n + 1, k,
        interpret=True))[:n].copy()
    out, _ = k4_model(*args, seed=3)
    smoke.sum_order_within("K4 model vs Pallas", out, torch.from_numpy(ref),
                           *_k4_limit_args(*args))


def test_k4_dropped_rows_add_nothing():
    """A dropped row's r_lat is never read: NaN there (dump rows and w == 0
    rows alike) gives the model's result on zeros there, bit for bit, with
    the adds in the same order."""
    num_bar, w, r_lat, idx_ext, n = _k4_inputs(seed=11)
    flat = idx_ext.reshape(-1)
    drop = ~((flat >= 0) & (flat < n) & (w != 0))
    nan_r = r_lat.clone()
    nan_r[drop] = float("nan")
    zero_r = r_lat.clone()
    zero_r[drop] = 0
    a, _ = k4_model(num_bar, w, nan_r, idx_ext, n, seed=4)
    b, _ = k4_model(num_bar, w, zero_r, idx_ext, n, seed=4)
    assert bool(torch.isfinite(a).all()) and torch.equal(a, b)
