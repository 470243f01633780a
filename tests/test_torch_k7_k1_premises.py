"""The premises of K7a's and K1 packed's kernels, on the CPU.

K7a runs K6a's kernel (``csrc/sdf_agg.cu`` ``rows_body``) with a gather
that reads x_pi from ``u = [lat | x_pi]``: on ``u = [g_lat | x - g_pos]``
it must give K6a's s and r bit for bit, which the plain versions show
here in bf16 and in f32.

K1 packed selects the k nearest of a cell's list with a group of G lanes
per query: lane l takes the candidates l, l + G, ..., keeps its own k
smallest packed keys in order, and the group takes k rounds of a minimum
over the lanes' heads, the lane that owns it advancing.  Packed keys are
distinct (ids are unique within a list and sit in the key's low bits), so
any way of taking the k smallest gives the same keys in the same order.
:func:`group_select` models the kernel so in torch; it is held against
the plain version and against the TPU kernel in interpret mode, on lists
of 0, 1, k - 1, k and qcap candidates, a qcap below k, cells outside the
grid and a query count that is no whole number of blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spurfies_tpu.config import ModelConfig
from spurfies_tpu.model.networks import init_model_params
from spurfies_tpu.ops.pallas_select import select_knn_pallas
from spurfies_tpu_torch.convert.from_jax import params_from_numpy
from spurfies_tpu_torch.ops import pair_mlp as tpm
from spurfies_tpu_torch.ops import select_knn as sk

K = 8


# ------------------------------------------------------------- K7a ----

@pytest.fixture(scope="module")
def frozen():
    f = init_model_params(jax.random.PRNGKey(0), ModelConfig())["frozen"]
    return params_from_numpy(jax.tree_util.tree_map(np.array, f), "cpu")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k7a_on_k6a_rows_is_k6a(frozen, dtype):
    """Plain K7a on ``u = [g_lat | x - g_pos]`` against plain K6a on
    ``(g, x)``: s and r bit-equal; 300 seeded rows, a tenth of them
    gathered row 0 (masked slots), as the compacted shading pairs have."""
    rng = np.random.default_rng(10)
    table = np.concatenate([rng.normal(0, 0.3, (40, 32)),
                            rng.uniform(-0.5, 0.5, (40, 3))], 1)
    rows = rng.integers(0, 40, 300)
    rows[rng.uniform(size=300) < 0.1] = 0
    g = table[rows]
    x = g[:, 32:] + rng.normal(0, 0.03, (300, 3))
    g, x = (torch.from_numpy(a.astype(np.float32)) for a in (g, x))
    prior = tpm._prep_layers(frozen, dtype)
    s6, r6, xpi = tpm.pair_sdf_rows_grad(g, x, prior)
    u = torch.cat([g[:, :32], x - g[:, 32:]], 1)
    assert torch.equal(u[:, 32:], xpi)
    s7, r7 = tpm.pair_sdf_value_and_input_grad(u, prior)
    assert torch.equal(s7, s6) and torch.equal(r7, r6)


# -------------------------------------------------------------- K1 ----

def group_select(x, cid, qidx, qpos, radius2, k, group):
    """The lane-group selection of ``csrc/select_knn.cu``'s packed kernel,
    in torch: lane l of a query's group keeps the k smallest packed keys of
    its candidates t = l, l + group, ... (in order), then k rounds take the
    minimum of the lanes' heads and advance the lane that owns it."""
    m, q = x.shape[0], qidx.shape[1]
    in_grid = (cid >= 0) & (cid < qidx.shape[0])
    c = torch.where(in_grid, cid, 0).long()
    cand = torch.where(in_grid[:, None], qidx[c], -1)
    diff = qpos[c] - x[:, :, None]
    d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) \
        + diff[:, 2] * diff[:, 2]
    ok = (cand >= 0) & (d2 <= radius2)
    key = (d2.view(torch.int32) & ~sk._ID_MASK) | cand
    key = torch.where(ok, key, sk._SENTINEL)
    pad = (-q) % group
    key = torch.cat([key, key.new_full((m, pad), sk._SENTINEL)], 1)
    # lane l holds columns l, l + group, ...: [M, group, (q + pad) / group]
    lanes = key.view(m, -1, group).transpose(1, 2)
    lanes = lanes.sort(2).values[:, :, :k]
    lanes = torch.cat([lanes, lanes.new_full((m, group, 1), sk._SENTINEL)],
                      2)                         # an exhausted lane's head
    head = torch.zeros((m, group), dtype=torch.long)
    out = []
    for _ in range(k):
        heads = torch.gather(lanes, 2, head[:, :, None])[:, :, 0]
        best, owner = heads.min(1)
        out.append(best)
        head[torch.arange(m), owner] += (best < sk._SENTINEL).long()
    keys = torch.stack(out, 1)
    valid = keys < sk._SENTINEL
    idx = torch.where(valid, keys & sk._ID_MASK, -1).to(torch.int32)
    dk = torch.where(valid, (keys & ~sk._ID_MASK).view(torch.float32),
                     float("inf"))
    return idx, dk


def _lists(q, m, seed):
    """A table of cells whose lists hold 0, 1, k - 1, k and q candidates
    (front-first, unique ids < 2**15, positions inf where empty) and a
    few random lengths; m queries (no whole number of 128-query blocks),
    each near its cell's candidates, a tenth of them with a cell outside
    the grid (-7, -1, C, C + 5)."""
    rng = np.random.default_rng(seed)
    lengths = [0, 1, K - 1, K, q] + list(rng.integers(0, q + 1, 11))
    lengths = [min(n, q) for n in lengths]
    c = len(lengths)
    qidx = np.full((c, q), -1, np.int32)
    qpos = np.full((c, 3, q), np.inf, np.float32)
    centre = rng.uniform(-0.5, 0.5, (c, 3)).astype(np.float32)
    for i, n in enumerate(lengths):
        qidx[i, :n] = rng.choice(2 ** 15, n, replace=False)
        qpos[i, :, :n] = (centre[i][:, None]
                          + rng.normal(0, 0.02, (3, n))).astype(np.float32)
    cid = rng.integers(0, c, m).astype(np.int32)
    cid[:5] = np.arange(5)                       # each listed length once
    x = (centre[cid] + rng.normal(0, 0.01, (m, 3))).astype(np.float32)
    out = rng.uniform(size=m) < 0.1
    out[:5] = False
    cid[out] = rng.choice([-7, -1, c, c + 5], int(out.sum()))
    return tuple(torch.from_numpy(a) for a in (x, cid, qidx, qpos))


@pytest.mark.parametrize("q", [64, 20, 4], ids=["qcap64", "qcap20", "q<k"])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
def test_group_select_is_the_plain_packed_select(q, group):
    """The lane-group model against ``select_knn_ref(packed=True)``: ids
    and d2 bit-equal for any group size, the radius cutting some lists
    short of k."""
    x, cid, qidx, qpos = _lists(q, 1001, seed=q)
    r2 = float(np.float32(0.04 ** 2))
    gi, gd = group_select(x, cid, qidx, qpos, r2, K, group)
    ri, rd = sk.select_knn_ref(x, cid, qidx, qpos, r2, K, packed=True)
    assert torch.equal(gi, ri) and torch.equal(gd, rd)
    in_grid = (cid >= 0) & (cid < qidx.shape[0])
    assert bool((gi[~in_grid] == -1).all()) and bool((~in_grid).any())
    length = torch.where(in_grid, (qidx[cid.clamp(0, qidx.shape[0] - 1)]
                                   >= 0).sum(1), 0)
    assert length[:5].tolist() == [min(n, q) for n in (0, 1, K - 1, K, q)]
    found = (gi >= 0).sum(1)
    # the radius cuts some lists short of k; some queries find k (or q)
    assert bool((found < length.clamp(max=K)).any())
    assert bool((found == min(K, q)).any())


@pytest.mark.parametrize("q", [64, 4], ids=["qcap64", "q<k"])
def test_group_select_is_the_pallas_packed_select(q):
    """The lane-group model (the kernel's group size) against the TPU
    kernel in interpret mode on the same gathered candidates, as
    ``tests/test_torch_select_knn.py`` runs it: ids and d2 bit-equal."""
    x, cid, qidx, qpos = _lists(q, 1001, seed=100 + q)
    r2 = float(np.float32(0.04 ** 2))
    in_grid = (cid >= 0) & (cid < qidx.shape[0])
    c = torch.where(in_grid, cid, 0).long()
    cand = torch.where(in_grid[:, None], qidx[c], -1)
    pi, pd = select_knn_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(cand.numpy()),
        jnp.asarray(qpos[c].numpy()), k=K, radius2=r2, tile=512,
        interpret=True, packed=True)
    gi, gd = group_select(x, cid, qidx, qpos, r2, K, sk.GROUP)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(pd))
