"""K5: row scatter-add, the colour-latent gradient.

Port of ``spurfies_tpu/ops/pallas_scatter.py`` (``scatter_add_rows`` ->
``_scatter_kernel``): ``out[idx[m]] += ct[m]``, a row whose index lies
outside ``[0, n)`` dropped.  On the training path it is the backward of
``model.field.gather_pair_rows``: the ``[M*K, 64 + 3]`` cotangent of the
colour pair rows, of which the 64 latent columns are read through a row
stride and scattered into ``[N, 64]``.

The CUDA kernel is ``csrc/scatter_rows.cu``; :func:`scatter_add_rows_ref`
is its plain PyTorch version (CPU tensors, and the kernel's yardstick on
the card).  The kernel sums the rows of one index within a 256-row tile in
a fixed order, skips the sums that are 0 (adding +-0 to a sum that starts
at +0 changes no bit) and adds the rest with atomics, so the two agree up
to f32 reordering.
"""

import ctypes

import torch

from spurfies_tpu_torch.ops import cuda_build

LAUNCHES = {"scatter_add_rows": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"scatter_add_rows_launch": [_P, _I, _P, _I, _I, _I, _P, _P]}


def scatter_add_rows_ref(ct: torch.Tensor, idx: torch.Tensor, n: int):
    """Plain K5: ``index_add_`` of the kept rows into ``[n, d]`` f32 (the
    dropped rows go to a spare row n, cut off at the end)."""
    keep = (idx >= 0) & (idx < n)
    out = torch.zeros((n + 1, ct.shape[1]), dtype=torch.float32,
                      device=ct.device)
    out.index_add_(0, torch.where(keep, idx, n).long(), ct.float())
    return out[:n]


def scatter_add_rows(ct: torch.Tensor, idx: torch.Tensor, n: int):
    """K5: ``[n, d]`` f32 with ``out[idx[m]] += ct[m]``.

    ct: ``[M, d]`` f32 whose columns are contiguous (``ct.stride(1) == 1``);
    its rows may be strided, as a column slice of a wider array is.
    idx: ``[M]`` int32.  CPU tensors run :func:`scatter_add_rows_ref`; CUDA
    tensors launch the kernel.
    """
    if ct.device != idx.device:
        raise ValueError("scatter_add_rows: ct and idx on different devices")
    if ct.ndim != 2 or idx.shape != (ct.shape[0],):
        raise ValueError(f"scatter_add_rows: ct [M, d] and idx [M], got "
                         f"{tuple(ct.shape)} and {tuple(idx.shape)}")
    if ct.device.type == "cpu":
        return scatter_add_rows_ref(ct, idx, n)
    if ct.device.type != "cuda":
        raise ValueError(f"scatter_add_rows: unsupported device {ct.device}")
    m, d = ct.shape
    if ct.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError("scatter_add_rows: ct must be f32 and idx int32")
    if n <= 0 or (m > 0 and (ct.stride(1) != 1 or ct.stride(0) < d)) or \
            not idx.is_contiguous():
        raise ValueError("scatter_add_rows: ct needs unit column stride and "
                         "a row stride >= d, idx must be contiguous, n > 0")
    out = torch.zeros((n, d), dtype=torch.float32, device=ct.device)
    lib = cuda_build.load("scatter_rows", _SIG)
    err = lib.scatter_add_rows_launch(
        ct.data_ptr(), ct.stride(0), idx.data_ptr(), m, d, n, out.data_ptr(),
        torch.cuda.current_stream(ct.device).cuda_stream)
    cuda_build.check(err, "scatter_add_rows")
    LAUNCHES["scatter_add_rows"] += 1
    return out
