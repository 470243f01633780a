"""K1: radius-limited k-nearest selection over per-cell candidate lists.

Port of ``spurfies_tpu/ops/pallas_select.py`` (``select_knn_pallas``).  The
CUDA kernel is ``csrc/select_knn.cu``; :func:`select_knn_ref` is its plain
PyTorch version, used for CPU tensors and as the kernel's yardstick on the
card.  Unlike the TPU kernel, both take the query's cell id and the
per-cell table itself, so the ``[M, qcap]`` candidate gathers never exist
outside the plain version.

Two variants, picked by the caller (``ops.voxel_grid.query_grid`` gates on
the cloud size as ``spurfies_tpu/ops/voxel_grid.py:340`` does):
  * exact: order by (d2 ascending, id descending);
  * packed: key = f32 bits of d2 with the low 15 mantissa bits replaced by
    the id; ids must be < 2**15; d2 comes back rounded to ~2**-8 relative.

The kernel runs a group of lanes a query (``GROUP`` packed,
``EXACT_GROUP`` exact), lane l keeping the k smallest keys of the
candidates l, l + G, ..., and merges them in k rounds of a group minimum.
The exact variant's key is 64 bits: d2's f32 bits above ``0xFFFFFFFF -
id``.  Keys are distinct within a list, so the result is the plain
version's bit for bit (``tests/test_torch_k7_k1_premises.py`` and
``tests/test_torch_k4_k1x_premises.py`` model it).
"""

import ctypes

import torch

from spurfies_tpu_torch.ops import cuda_build
from spurfies_tpu_torch.utils import profiling

ID_BITS = 15
_ID_MASK = (1 << ID_BITS) - 1
_SENTINEL = 1 << 30            # > every packed key (d2 < 2)
SUPPORTED_K = (1, 2, 4, 8, 16)
GROUP = 4                      # kPackedGroup: lanes a query, packed
EXACT_GROUP = 8                # kExactGroup: lanes a query, exact

profiling.register("select_knn_packed", "select_knn_exact")

_SIG = {"select_knn_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]}


def select_knn_ref(x, cid, qidx, qpos, radius2: float, k: int = 8,
                   packed: bool = False):
    """Plain version.

    Args:
      x: ``[M, 3]`` f32 queries.
      cid: ``[M]`` int32 cell of each query; outside ``[0, C)`` (e.g. -1):
        outside the grid, no neighbours.
      qidx: ``[C, Q]`` int32 per-cell candidate ids (-1 empty).
      qpos: ``[C, 3, Q]`` f32 candidate positions.
      radius2: squared radius (compared in f32).

    Returns (idx ``[M, k]`` int32 nearest-first, -1 empty; d2 ``[M, k]``
    f32, inf empty).
    """
    m, q = x.shape[0], qidx.shape[1]
    r2 = torch.tensor(radius2, dtype=torch.float32, device=x.device)
    in_grid = (cid >= 0) & (cid < qidx.shape[0])
    c = torch.where(in_grid, cid, 0).long()
    cand = torch.where(in_grid[:, None], qidx[c], -1)          # [M, Q]
    diff = qpos[c] - x[:, :, None]                             # [M, 3, Q]
    d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) \
        + diff[:, 2] * diff[:, 2]
    ok = (cand >= 0) & (d2 <= r2)
    if q < k:
        pad = k - q
        cand = torch.cat([cand, cand.new_full((m, pad), -1)], 1)
        d2 = torch.cat([d2, d2.new_full((m, pad), float("inf"))], 1)
        ok = torch.cat([ok, ok.new_zeros((m, pad))], 1)
    if packed:
        key = (d2.view(torch.int32) & ~_ID_MASK) | cand
        key = torch.where(ok, key, _SENTINEL)
        key = torch.sort(key, dim=1).values[:, :k]
        valid = key < _SENTINEL
        idx = torch.where(valid, key & _ID_MASK, -1)
        dk = torch.where(valid, (key & ~_ID_MASK).view(torch.float32),
                         float("inf"))
        return idx.to(torch.int32), dk
    d2 = torch.where(ok, d2, float("inf"))
    # (d2 ascending, id descending): a stable sort by id, then by d2
    by_id = torch.argsort(cand, dim=1, descending=True, stable=True)
    by_d2 = torch.argsort(torch.gather(d2, 1, by_id), dim=1, stable=True)
    pos = torch.gather(by_id, 1, by_d2[:, :k])
    dk = torch.gather(d2, 1, pos)
    idx = torch.where(torch.isfinite(dk), torch.gather(cand, 1, pos), -1)
    return idx.to(torch.int32), dk


def select_knn(x, cid, qidx, qpos, radius2: float, k: int = 8,
               packed: bool = False):
    """K1.  CPU tensors run :func:`select_knn_ref`; CUDA tensors launch the
    kernel.  The table's lists must be packed front-first (as
    ``build_query_table`` makes them): the kernel stops at a list's first
    empty slot."""
    if x.device.type == "cpu":
        return select_knn_ref(x, cid, qidx, qpos, radius2, k, packed)
    if x.device.type != "cuda":
        raise ValueError(f"select_knn: unsupported device {x.device}")
    m, q = x.shape[0], qidx.shape[1]
    if k not in SUPPORTED_K:
        raise ValueError(f"select_knn: k={k} not in {SUPPORTED_K}")
    for name, t, dtype, shape in (("x", x, torch.float32, (m, 3)),
                                  ("cid", cid, torch.int32, (m,)),
                                  ("qidx", qidx, torch.int32, None),
                                  ("qpos", qpos, torch.float32,
                                   (qidx.shape[0], 3, q))):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"select_knn: {name} must be a contiguous "
                             f"{dtype} tensor on {x.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"select_knn: {name} shape {tuple(t.shape)} "
                             f"!= {shape}")
    out_idx = torch.empty((m, k), dtype=torch.int32, device=x.device)
    out_d2 = torch.empty((m, k), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("select_knn", _SIG)
    err = lib.select_knn_launch(
        x.data_ptr(), cid.data_ptr(), qidx.data_ptr(), qpos.data_ptr(), m,
        qidx.shape[0], q, k, float(radius2), int(packed), out_idx.data_ptr(),
        out_d2.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "select_knn")
    profiling.count("select_knn_packed" if packed else "select_knn_exact")
    return out_idx, out_d2
