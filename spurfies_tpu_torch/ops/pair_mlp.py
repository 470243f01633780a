"""K2 / K3: fused gather + frozen-prior pair MLP + RBF weight + per-point
aggregation.

Port of the fused-aggregation kernels of ``spurfies_tpu/ops/pallas_mlp.py``:
  * K2 ``pair_sdf_value_agg`` (``_fused_value_agg_call``): per point
    ``(sum_k w s, sum_k w)`` -- the sampler's no-grad probe;
  * K3 ``pair_sdf_aggregate`` (``_fused_agg_call``): per point
    ``(sum_k w s, sum_k w, sum_k w ds/dx)`` plus the per-pair residuals
    ``w`` and ``r_lat = ds/dlat`` that the training slice's latent gradient
    consumes.

The CUDA kernels are ``csrc/pair_mlp.cu``; ``*_ref`` are their plain
PyTorch versions (CPU tensors, and the kernels' yardstick on the card).
Both follow the TPU kernel's rounding points: operands in the compute
dtype, f32 accumulation, bias added in f32, activations rounded after each
LeakyReLU, the down-sweep delta rounded after each gate and each product.

Pair rows are point-major: ``idx_ext [P, k]`` indexes a table
``[N+1, 32+3] = [latent | position]`` whose row N is the dump row at
``DUMP_POS``; an invalid pair points there and gets w == 0 exactly.  An
index outside ``[0, N]`` reads the dump row too.
"""

import ctypes
from dataclasses import dataclass

import torch

from spurfies_tpu_torch.ops import cuda_build

DUMP_POS = 1.0e9        # dump-row position: w = exp(-rbf^2 * ~1e18) == 0
HID = 256
LAT = 32
_ROWS = 128             # pair rows per CUDA block
_IN0, _OUT0 = 48, 40    # padded first-layer depth / last down-sweep width

LAUNCHES = {"pair_sdf_value_agg": 0, "pair_sdf_aggregate": 0}

_P = ctypes.c_void_p
_SIG = {
    "pair_sdf_value_agg_launch": [_P, ctypes.c_int, _P, _P, ctypes.c_int,
                                  ctypes.c_int, _P, _P, ctypes.c_float, _P,
                                  _P],
    "pair_sdf_aggregate_launch": [_P, ctypes.c_int, _P, _P, ctypes.c_int,
                                  ctypes.c_int, _P, _P, ctypes.c_float, _P,
                                  _P, _P, _P],
}


@dataclass
class PriorLayers:
    """The frozen prior, prepared once (``_prep_layers``).

    ws: weights ``[in, out]`` in the compute dtype (the last one the fused
    256->1 tail); bs: biases in f32 ``[1, out]``; n_act: layers with a
    LeakyReLU.  The kernel's packed buffers are made on first use.
    """
    ws: list
    bs: list
    n_act: int
    compute_dtype: torch.dtype
    _packed: tuple = None

    def kernel_buffers(self):
        """(bf16 weights, f32 biases) in the layout of csrc/pair_mlp.cu."""
        if self._packed is None:
            if self.compute_dtype != torch.bfloat16:
                raise ValueError("the pair-MLP kernels run in bf16 only; "
                                 f"got compute dtype {self.compute_dtype}")
            if self.n_act != 4 or len(self.ws) != 5 or \
                    tuple(self.ws[0].shape) != (LAT + 3, HID):
                raise ValueError("the pair-MLP kernels take the 35->256x4->1 "
                                 "prior of ModelConfig's defaults")
            w0 = self.ws[0]
            dev = w0.device
            up0 = torch.zeros(HID, _IN0, dtype=torch.bfloat16, device=dev)
            up0[:, :LAT + 3] = w0.t()
            dn0 = torch.zeros(_OUT0, HID, dtype=torch.bfloat16, device=dev)
            dn0[:LAT + 3] = w0
            parts = [up0.reshape(-1)]
            parts += [w.t().contiguous().reshape(-1) for w in self.ws[1:4]]
            parts += [w.contiguous().reshape(-1) for w in self.ws[1:4]]
            parts += [dn0.reshape(-1), self.ws[4].reshape(-1)]
            wbuf = torch.cat(parts).contiguous()
            bbuf = torch.cat([b.reshape(-1).float() for b in self.bs])
            self._packed = (wbuf, bbuf.contiguous())
        return self._packed


def _prep_layers(frozen, compute_dtype=torch.bfloat16) -> PriorLayers:
    """Cast + linear-tail fusion (``spurfies_tpu/ops/pallas_mlp.py:401-431``).

    The activations stop after layer n_act-1 (LeakyReLU follows
    F_geometry[0..3] only); F_geometry[4] and T are plain linear and fuse
    EXACTLY, in f32 before the cast, into one 256->1 layer:
    w_v = W4 @ W_T, b_v = b4 @ W_T + b_T.
    """
    layers = [(l["w"], l["b"]) for l in frozen["F_geometry"]]
    layers += [(l["w"], l["b"]) for l in frozen["T"]]
    n_act = len(frozen["F_geometry"]) - 1
    w_tail, b_tail = layers[n_act]
    wv = w_tail.float()
    bv = b_tail.float()
    for w, b in layers[n_act + 1:]:
        bv = bv @ w.float() + b.float()
        wv = wv @ w.float()
    fused = layers[:n_act] + [(wv, bv)]
    ws = [w.to(compute_dtype) for w, _ in fused]
    bs = [(b.float()[None] if b.ndim == 1 else b.float()) for _, b in fused]
    return PriorLayers(ws, bs, n_act, compute_dtype)


def _mm(a, w):
    """Product of compute-dtype operands accumulated in f32."""
    return a.to(w.dtype).float() @ w.float()


def _gather(table, idx_ext, x, rbf: float):
    """Pair rows, x_pi, w: ``g [P*k, d+3]``, ``xpi [P*k, 3]``, ``w [P*k]``."""
    k = idx_ext.shape[1]
    rows = table.shape[0]
    idx = idx_ext.reshape(-1).long()
    g = table[torch.where((idx >= 0) & (idx < rows), idx, rows - 1)]
    xpi = torch.repeat_interleave(x, k, dim=0) - g[:, -3:]
    d2 = (xpi[:, 0] * xpi[:, 0] + xpi[:, 1] * xpi[:, 1]) + xpi[:, 2] * xpi[:, 2]
    rbf2 = torch.tensor(float(rbf) ** 2, dtype=torch.float32, device=x.device)
    w = torch.exp(-rbf2 * d2)
    return g, xpi, w


def _up_sweep(layers: PriorLayers, g, xpi, keep_gates: bool):
    """s [T] (rounded to the compute dtype) and the gates of layers
    0..n_act-1 (bool, a > 0)."""
    cd = layers.compute_dtype
    d = g.shape[1] - 3
    w0 = layers.ws[0]
    a = (_mm(g[:, :d], w0[:d]) + _mm(xpi, w0[d:])) + layers.bs[0]
    gates = []
    x = None
    for i in range(len(layers.ws)):
        if i > 0:
            a = _mm(x, layers.ws[i]) + layers.bs[i]
        if i < layers.n_act:
            if keep_gates:
                gates.append(a > 0)
            x = torch.maximum(a, 0.01 * a).to(cd)
        else:
            x = a.to(cd)
    return x[:, 0].float(), gates


def pair_sdf_value_agg_ref(table, idx_ext, x, layers: PriorLayers,
                           rbf: float):
    """Plain K2: ``pt [P, 2] = (sum_k w s, sum_k w)``."""
    p, k = idx_ext.shape
    g, xpi, w = _gather(table, idx_ext, x, rbf)
    s, _ = _up_sweep(layers, g, xpi, keep_gates=False)
    cols = torch.stack([w * s, w], dim=1)
    return cols.view(p, k, 2).sum(dim=1)


def pair_sdf_aggregate_ref(table, idx_ext, x, layers: PriorLayers,
                           rbf: float):
    """Plain K3: ``(pt [P, 5] = (sum w s, sum w, sum w ds/dx), w [P*k],
    r_lat [P*k, 32])``, r_lat in the compute dtype."""
    p, k = idx_ext.shape
    cd = layers.compute_dtype
    g, xpi, w = _gather(table, idx_ext, x, rbf)
    s, gates = _up_sweep(layers, g, xpi, keep_gates=True)
    slope = torch.tensor(0.01, dtype=cd, device=x.device).float()
    delta = layers.ws[-1].t().expand(g.shape[0], -1)        # [T, 256]
    for i in range(layers.n_act - 1, -1, -1):
        delta = (delta.float() * torch.where(gates[i], 1.0, slope)).to(cd)
        delta = _mm(delta, layers.ws[i].t()).to(cd)
    r = delta.float()                                       # [T, d+3]
    d = g.shape[1] - 3
    cols = torch.cat([(w * s)[:, None], w[:, None], w[:, None] * r[:, d:]], 1)
    return cols.view(p, k, 5).sum(dim=1), w, r[:, :d].to(cd)


def _check_inputs(name, table, idx_ext, x):
    if table.device != x.device or idx_ext.device != x.device:
        raise ValueError(f"{name}: inputs on different devices")
    p, k = idx_ext.shape
    if table.dtype != torch.float32 or tuple(table.shape[1:]) != (LAT + 3,):
        raise ValueError(f"{name}: table must be f32 [N+1, {LAT + 3}]")
    if idx_ext.dtype != torch.int32 or x.dtype != torch.float32 or \
            tuple(x.shape) != (p, 3):
        raise ValueError(f"{name}: idx_ext int32 [P, k] and x f32 [P, 3]")
    if _ROWS % k != 0:
        raise ValueError(f"{name}: k={k} must divide {_ROWS}")
    for t in (table, x):
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{name} is forward-only in this slice (its latent gradient "
                "is the training slice's K4); call it under torch.no_grad()")


def _pad_points(idx_ext, x, n_dump: int):
    """Pad P to whole CUDA blocks with dump-row pairs."""
    p, k = idx_ext.shape
    per_block = _ROWS // k
    pad = (-p) % per_block
    if pad:
        idx_ext = torch.cat([idx_ext, idx_ext.new_full((pad, k), n_dump)])
        x = torch.cat([x, x.new_zeros((pad, 3))])
    return idx_ext.contiguous(), x.contiguous(), p + pad


def pair_sdf_value_agg(table, idx_ext, x, layers: PriorLayers, rbf: float):
    """K2.  CPU tensors run :func:`pair_sdf_value_agg_ref`; CUDA tensors
    launch the kernel (bf16 compute only)."""
    _check_inputs("pair_sdf_value_agg", table, idx_ext, x)
    if x.device.type == "cpu":
        return pair_sdf_value_agg_ref(table, idx_ext, x, layers, rbf)
    if x.device.type != "cuda":
        raise ValueError(f"pair_sdf_value_agg: unsupported device {x.device}")
    p, k = idx_ext.shape
    wbuf, bbuf = layers.kernel_buffers()
    idx_p, x_p, pp = _pad_points(idx_ext, x, table.shape[0] - 1)
    table = table.contiguous()
    out = torch.empty((pp, 2), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("pair_mlp", _SIG)
    err = lib.pair_sdf_value_agg_launch(
        table.data_ptr(), table.shape[0], idx_p.data_ptr(), x_p.data_ptr(),
        pp, k, wbuf.data_ptr(), bbuf.data_ptr(), float(rbf) ** 2,
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "pair_sdf_value_agg")
    LAUNCHES["pair_sdf_value_agg"] += 1
    return out[:p]


def pair_sdf_aggregate(table, idx_ext, x, layers: PriorLayers, rbf: float):
    """K3 (forward only in this slice: a tensor that requires grad raises).
    CPU tensors run :func:`pair_sdf_aggregate_ref`; CUDA tensors launch the
    kernel (bf16 compute only).  Returns ``(pt [P, 5], w [P*k],
    r_lat [P*k, 32])``."""
    _check_inputs("pair_sdf_aggregate", table, idx_ext, x)
    if x.device.type == "cpu":
        return pair_sdf_aggregate_ref(table, idx_ext, x, layers, rbf)
    if x.device.type != "cuda":
        raise ValueError(f"pair_sdf_aggregate: unsupported device {x.device}")
    p, k = idx_ext.shape
    wbuf, bbuf = layers.kernel_buffers()
    idx_p, x_p, pp = _pad_points(idx_ext, x, table.shape[0] - 1)
    table = table.contiguous()
    pt = torch.empty((pp, 5), dtype=torch.float32, device=x.device)
    w = torch.empty((pp * k,), dtype=torch.float32, device=x.device)
    r = torch.empty((pp * k, LAT), dtype=torch.bfloat16, device=x.device)
    lib = cuda_build.load("pair_mlp", _SIG)
    err = lib.pair_sdf_aggregate_launch(
        table.data_ptr(), table.shape[0], idx_p.data_ptr(), x_p.data_ptr(),
        pp, k, wbuf.data_ptr(), bbuf.data_ptr(), float(rbf) ** 2,
        pt.data_ptr(), w.data_ptr(), r.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "pair_sdf_aggregate")
    LAUNCHES["pair_sdf_aggregate"] += 1
    return pt[:p], w[:p * k], r[:p * k]
