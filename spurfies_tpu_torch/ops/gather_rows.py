"""K9: row gather from a table, ``out[m] = table[idx[m]]``.

Port of ``scripts/micro_gather.py`` (``gather_rows_pallas`` ->
``_gather_kernel``), the microbenchmark of an in-kernel row gather from a
resident point table.  Its only caller is the port's microbenchmark,
``python -m spurfies_tpu_torch.scripts.micro_gather``.

The CUDA kernel is ``csrc/gather_rows.cu``; :func:`gather_rows_ref` is its
plain PyTorch version (CPU tensors, and the kernel's yardstick on the
card).  A gather moves bits: the two agree bit for bit.
"""

import ctypes

import torch

from spurfies_tpu_torch.ops import cuda_build
from spurfies_tpu_torch.utils import profiling

profiling.register("gather_rows")
ROWS_PER_BLOCK = 32             # the default; the microbenchmark sweeps it

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"gather_rows_launch": [_P, _I, _I, _P, ctypes.c_longlong, _P, _I, _I,
                               _P]}


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor):
    """Plain K9: ``table[idx]``."""
    return table[idx.long()]


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                rows_per_block: int = ROWS_PER_BLOCK):
    """K9: ``[m, d]`` f32 rows ``table[idx[m]]``.

    table: ``[n, d]`` f32, contiguous; idx: ``[m]`` int32 in ``[0, n)`` (as
    in the JAX script; on the card a row outside reads as zeros, on the
    CPU it raises).  CPU tensors run :func:`gather_rows_ref`; CUDA tensors
    launch the kernel with ``rows_per_block`` rows a block.
    """
    if table.device != idx.device:
        raise ValueError("gather_rows: table and idx on different devices")
    if table.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"gather_rows: table [n, d] and idx [m], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.device.type == "cpu":
        return gather_rows_ref(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError("gather_rows: table must be f32 and idx int32")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: table and idx must be contiguous")
    n, d = table.shape
    m = idx.shape[0]
    out = torch.empty((m, d), dtype=torch.float32, device=table.device)
    vec4 = d % 4 == 0 and table.data_ptr() % 16 == 0 and \
        out.data_ptr() % 16 == 0
    vpr = d // 4 if vec4 else d
    if not 0 < rows_per_block * vpr <= 1024:
        raise ValueError(f"gather_rows: {rows_per_block} rows of {vpr} "
                         "vectors is not a block of 1..1024 threads")
    lib = cuda_build.load("gather_rows", _SIG)
    err = lib.gather_rows_launch(
        table.data_ptr(), n, d, idx.data_ptr(), m, out.data_ptr(),
        rows_per_block, int(vec4),
        torch.cuda.current_stream(table.device).cuda_stream)
    cuda_build.check(err, "gather_rows")
    profiling.count("gather_rows")
    return out
