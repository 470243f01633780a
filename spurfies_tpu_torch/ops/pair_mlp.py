"""K2 / K3 / K4: fused gather + frozen-prior pair MLP + RBF weight +
per-point aggregation, and its latent gradient; K6 / K7: the same prior
per pair row, without weight or aggregation.

Port of the fused-aggregation kernels of ``spurfies_tpu/ops/pallas_mlp.py``:
  * K2 ``pair_sdf_value_agg`` (``_fused_value_agg_call``): per point
    ``(sum_k w s, sum_k w)`` -- the sampler's no-grad probe;
  * K3 ``pair_sdf_aggregate`` (``_fused_agg_call``): per point
    ``(sum_k w s, sum_k w, sum_k w ds/dx)`` plus the per-pair residuals
    ``w`` and ``r_lat = ds/dlat`` that K4 consumes;
  * K4 ``pair_sdf_aggregate_bwd`` (``_fused_agg_bwd_call``): K3's latent
    gradient ``out[idx] += num_bar[point] * w * r_lat``.
  * K6a ``pair_sdf_rows_grad`` (``_fused_mlp_gx_call``) and K6b
    ``pair_sdf_rows_value`` (``_fused_value_gx_call``): from raw gathered
    rows ``g = [latent | position]`` and a query ``x`` per row, per row
    ``s``, ``x_pi = x - position`` and (K6a) ``r = ds/du`` with
    ``u = [latent | x_pi]`` -- the ``model.fused_agg=false`` path;
  * K7a ``pair_sdf_value_and_input_grad`` (``_fused_mlp_call``) and K7b
    ``pair_sdf_value`` (``_fused_value_call``): ``s`` and (K7a) ``r`` from
    a pre-assembled ``u`` -- the pair-compacted SDF.
The autograd Function :class:`PairSdfAggregate` puts K3 forward and K4
backward together, as the custom VJP of ``spurfies_tpu/model/field.py``'s
``pair_sdf_aggregate`` does; :class:`PairSdfRowsGrad` (K6a) and
:class:`PairSdfValueAndInputGrad` (K7a) are the custom VJPs of
``spurfies_tpu/ops/pallas_mlp.py:458-533``, whose backwards are
elementwise (no kernel, as in the JAX package).

The CUDA kernels are ``csrc/sdf_agg.cu`` (K2, K3, K6a, K6b, K7a, K7b: one
``wgmma`` pipeline) and ``csrc/agg_bwd.cu`` (K4);
``*_ref`` are their plain PyTorch versions (CPU tensors, and the kernels'
yardstick on the card).  The pair-MLP kernels
follow the TPU kernels' rounding points: operands in the compute dtype,
f32 accumulation, bias added in f32, activations rounded after each
LeakyReLU, ``s`` rounded to the compute dtype, the down-sweep delta
rounded after each gate and each product (``r`` is that delta).  K4 sums
with atomics, so it agrees with its plain version up to f32 reordering.

While a profiler session runs, K3 and K2 hand their ``idx_ext`` to the
program's real-pair counter (:func:`utils.profiling.hold_pairs`), on the
CPU path and the card's alike; every launch is counted in
``utils.profiling.COUNTS``.

Pair rows are point-major: ``idx_ext [P, k]`` indexes a table
``[N+1, 32+3] = [latent | position]`` whose row N is the dump row at
``DUMP_POS``; an invalid pair points there and gets w == 0 exactly.  An
index outside ``[0, N]`` reads the dump row too.
"""

import ctypes
from dataclasses import dataclass

import torch

from spurfies_tpu_torch.device import constant
from spurfies_tpu_torch.ops import cuda_build
from spurfies_tpu_torch.utils import profiling

DUMP_POS = 1.0e9        # dump-row position: w = exp(-rbf^2 * ~1e18) == 0
HID = 256
LAT = 32
_OUT0 = 40              # the last down-sweep width, padded to 8s

profiling.register("pair_sdf_value_agg", "pair_sdf_aggregate",
                   "pair_sdf_aggregate_bwd", "pair_sdf_rows_grad",
                   "pair_sdf_rows_value", "pair_sdf_value_and_input_grad",
                   "pair_sdf_value")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_AGG_IN = [_P, ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P,
           ctypes.c_float]          # table, n_rows, idx, x, P, k, wbuf, bbuf, rbf2
# the per-row kernels: inputs, m, wbuf, bbuf, outputs, stream
_SIG_SDF_AGG = {            # csrc/sdf_agg.cu: K3, K2, K6a, K6b, K7a, K7b
    "pair_sdf_aggregate_launch": _AGG_IN + [_P, _P, _P, _P],
    "pair_sdf_value_agg_launch": _AGG_IN + [_P, _P],
    "pair_sdf_rows_grad_launch": [_P, _P, _LL, _P, _P, _P, _P, _P, _P],
    "pair_sdf_rows_value_launch": [_P, _P, _LL, _P, _P, _P, _P, _P],
    "pair_sdf_pre_grad_launch": [_P, _LL, _P, _P, _P, _P, _P],
    "pair_sdf_pre_value_launch": [_P, _LL, _P, _P, _P, _P],
}
_SIG_BWD = {"pair_sdf_aggregate_bwd_launch": [_P, _P, _P, _P, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_int, _P,
                                              _P]}


@dataclass
class PriorLayers:
    """The frozen prior, prepared once (``_prep_layers``).

    ws: weights ``[in, out]`` in the compute dtype (the last one the fused
    256->1 tail); bs: biases in f32 ``[1, out]``; n_act: layers with a
    LeakyReLU.  The kernels' buffers are made on first use.
    """
    ws: list
    bs: list
    n_act: int
    compute_dtype: torch.dtype
    _bias: torch.Tensor = None
    _packed_k3: torch.Tensor = None

    def bias_buffer(self):
        """The f32 biases of ``csrc/sdf_agg.cu``: b0..b3 ``[4, 256]``, then
        b_v (1,025 floats).  Raises unless the prior is the kernels':
        bf16, 35->256x4->1."""
        if self._bias is None:
            if self.compute_dtype != torch.bfloat16:
                raise ValueError("the pair-MLP kernels run in bf16 only; "
                                 f"got compute dtype {self.compute_dtype}")
            if self.n_act != 4 or len(self.ws) != 5 or \
                    tuple(self.ws[0].shape) != (LAT + 3, HID):
                raise ValueError("the pair-MLP kernels take the 35->256x4->1 "
                                 "prior of ModelConfig's defaults")
            self._bias = torch.cat([b.reshape(-1).float()
                                    for b in self.bs]).contiguous()
        return self._bias

    def k3_buffer(self):
        """The bf16 weights of ``csrc/sdf_agg.cu`` (every pair-MLP kernel),
        packed once in the byte layout of its shared-memory stages, so that
        each of the 26 chunks is one contiguous bulk copy: chunk 0 is W0^T
        ``[256, 64]`` (k >= 35 zero); chunks 1-12 W_l^T for l = 1, 2, 3 (the
        up sweep ends here: K2, K6b and K7b stream chunks 0-12 only) and chunks
        13-24 W_l for l = 3, 2, 1, each layer as four ``[256, 64]`` column
        blocks; then W0 ``[40, 256]`` (rows >= 35 zero) as four ``[40, 64]``
        blocks, and w_v ``[256]``.  Every block is :func:`_swizzle128`'d.
        The biases are :meth:`bias_buffer`."""
        if self._packed_k3 is None:
            self.bias_buffer()                      # dtype and shape checks
            w0 = self.ws[0]
            up0 = w0.new_zeros(HID, 64)
            up0[:, :LAT + 3] = w0.t()
            dn0 = w0.new_zeros(_OUT0, HID)
            dn0[:LAT + 3] = w0
            parts = [_swizzle128(up0)]
            parts += [_swizzle128(w.t()) for w in self.ws[1:4]]
            parts += [_swizzle128(w) for w in self.ws[3:0:-1]]
            parts += [_swizzle128(dn0), self.ws[4].reshape(-1)]
            self._packed_k3 = torch.cat(parts).contiguous()
        return self._packed_k3


def _swizzle128(bt: torch.Tensor) -> torch.Tensor:
    """A K-major ``[rows, K]`` operand (K a multiple of 64) as the flat
    shared-memory image that ``csrc/sdf_agg.cu`` multiplies: K / 64 blocks
    of ``[rows, 64]``, each row 128 bytes whose 16-byte chunk c is stored at
    chunk ``c ^ (row % 8)`` (the 128-byte swizzle of ``wgmma``)."""
    rows, k = bt.shape
    blocks = bt.reshape(rows, k // 64, 8, 8).permute(1, 0, 2, 3)
    r = torch.arange(rows, device=bt.device)[:, None]
    src = torch.arange(8, device=bt.device)[None, :] ^ (r % 8)
    return blocks[:, r, src].reshape(-1)


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


def pair_table(latents: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``[N+1, D+3]`` rows ``[latent | position]``; row N is the dump row
    (zero latent, position DUMP_POS) that invalid pairs index."""
    d = latents.shape[1]
    dump = torch.cat([latents.new_zeros(1, d),
                      latents.new_full((1, 3), DUMP_POS)], 1)
    return torch.cat([torch.cat([latents, points.to(latents.dtype)], 1),
                      dump], 0).contiguous()


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
    rbf2 = constant(float(rbf) ** 2, torch.float32, x.device)
    w = torch.exp(-rbf2 * d2)
    return g, xpi, w


def _first_split(layers: PriorLayers, lat, xpi):
    """The first layer's pre-activation as the TPU kernels that take rows
    form it: ``lat @ W_lat + x_pi @ W_pos + b0``, each operand rounded."""
    d = lat.shape[1]
    w0 = layers.ws[0]
    return (_mm(lat, w0[:d]) + _mm(xpi, w0[d:])) + layers.bs[0]


def _up_sweep(layers: PriorLayers, a, keep_gates: bool):
    """s [T] (rounded to the compute dtype) and the gates of layers
    0..n_act-1 (bool, a > 0), from the first layer's pre-activation ``a``
    (bias added)."""
    cd = layers.compute_dtype
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


def _down_sweep(layers: PriorLayers, gates, t: int, device):
    """r = ds/du [T, 35] f32: the delta of the down sweep, rounded to the
    compute dtype after each gate and each product."""
    cd = layers.compute_dtype
    slope = constant(0.01, cd, device).float()
    delta = layers.ws[-1].t().expand(t, -1)                 # [T, 256]
    for i in range(layers.n_act - 1, -1, -1):
        delta = (delta.float() * torch.where(gates[i], 1.0, slope)).to(cd)
        delta = _mm(delta, layers.ws[i].t()).to(cd)
    return delta.float()


def value_terms(table, idx_ext, x, layers: PriorLayers, rbf: float):
    """Plain K2's per-pair terms: ``cols [P*k, 2] = (w s, w)``."""
    g, xpi, w = _gather(table, idx_ext, x, rbf)
    s, _ = _up_sweep(layers, _first_split(layers, g[:, :-3], xpi),
                     keep_gates=False)
    return torch.stack([w * s, w], dim=1)


def pair_sdf_value_agg_ref(table, idx_ext, x, layers: PriorLayers,
                           rbf: float):
    """Plain K2: ``pt [P, 2] = (sum_k w s, sum_k w)``."""
    p, k = idx_ext.shape
    return value_terms(table, idx_ext, x, layers, rbf).view(p, k, 2).sum(dim=1)


def aggregate_terms(table, idx_ext, x, layers: PriorLayers, rbf: float):
    """Plain K3's per-pair terms: ``(cols [P*k, 5] = (w s, w, w ds/dx),
    w [P*k], r_lat [P*k, 32])``, r_lat in the compute dtype."""
    cd = layers.compute_dtype
    g, xpi, w = _gather(table, idx_ext, x, rbf)
    d = g.shape[1] - 3
    s, gates = _up_sweep(layers, _first_split(layers, g[:, :d], xpi),
                         keep_gates=True)
    r = _down_sweep(layers, gates, g.shape[0], x.device)    # [T, d+3]
    cols = torch.cat([(w * s)[:, None], w[:, None], w[:, None] * r[:, d:]], 1)
    return cols, w, r[:, :d].to(cd)


def pair_sdf_aggregate_ref(table, idx_ext, x, layers: PriorLayers,
                           rbf: float):
    """Plain K3: ``(pt [P, 5] = (sum w s, sum w, sum w ds/dx), w [P*k],
    r_lat [P*k, 32])``, r_lat in the compute dtype."""
    p, k = idx_ext.shape
    cols, w, r_lat = aggregate_terms(table, idx_ext, x, layers, rbf)
    return cols.view(p, k, 5).sum(dim=1), w, r_lat


def _check_inputs(name, table, idx_ext, x):
    if table.device != x.device or idx_ext.device != x.device:
        raise ValueError(f"{name}: inputs on different devices")
    p, k = idx_ext.shape
    if table.dtype != torch.float32 or tuple(table.shape[1:]) != (LAT + 3,):
        raise ValueError(f"{name}: table must be f32 [N+1, {LAT + 3}]")
    if idx_ext.dtype != torch.int32 or x.dtype != torch.float32 or \
            tuple(x.shape) != (p, 3):
        raise ValueError(f"{name}: idx_ext int32 [P, k] and x f32 [P, 3]")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cuda" and k > 32:
        raise ValueError(f"{name}: k={k} must be at most 32")
    return x.device.type == "cpu"


def _launch_agg(name, table, idx_ext, x, layers: PriorLayers, rbf: float,
                outs):
    """Run K3 or K2 (the C entry ``{name}_launch`` of ``csrc/sdf_agg.cu``)
    into the new tensors ``outs``."""
    p, k = idx_ext.shape
    bbuf = layers.bias_buffer()
    wbuf = layers.k3_buffer()
    idx_ext, x, table = (t.contiguous() for t in (idx_ext, x, table))
    lib = cuda_build.load("sdf_agg", _SIG_SDF_AGG)
    err = getattr(lib, f"{name}_launch")(
        table.data_ptr(), table.shape[0], idx_ext.data_ptr(), x.data_ptr(),
        p, k, wbuf.data_ptr(), bbuf.data_ptr(), float(rbf) ** 2,
        *(t.data_ptr() for t in outs),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, name)
    profiling.count(name)
    return outs


@torch.no_grad()
def pair_sdf_value_agg(table, idx_ext, x, layers: PriorLayers, rbf: float):
    """K2 (forward only: its outputs carry no gradient).  CPU tensors run
    :func:`pair_sdf_value_agg_ref`; CUDA tensors launch the kernel (bf16
    compute only).  Returns ``pt [P, 2]``.

    The kernel is K3 without the down sweep: it computes only the real
    pairs (index in ``[0, N)``), and each point's sums skip the dump pairs'
    terms, which are +-0, so they are what adding them in j order gives;
    a point with no real pair gets ``(0, 0)``.  Its ``pt`` is K3's
    ``pt[:, :2]`` bit for bit."""
    cpu = _check_inputs("pair_sdf_value_agg", table, idx_ext, x)
    profiling.hold_pairs("k2", idx_ext, table.shape[0] - 1)
    if cpu:
        return pair_sdf_value_agg_ref(table, idx_ext, x, layers, rbf)
    pt = torch.empty((idx_ext.shape[0], 2), dtype=torch.float32,
                     device=x.device)
    return _launch_agg("pair_sdf_value_agg", table, idx_ext, x, layers, rbf,
                       (pt,))[0]


@torch.no_grad()
def pair_sdf_aggregate(table, idx_ext, x, layers: PriorLayers, rbf: float):
    """K3, forward only: its outputs carry no gradient (the differentiable
    form is :class:`PairSdfAggregate`).  CPU tensors run
    :func:`pair_sdf_aggregate_ref`; CUDA tensors launch the kernel (bf16
    compute only).  Returns ``(pt [P, 5], w [P*k], r_lat [P*k, 32])``.

    The kernel computes only the real pairs (index in ``[0, N)``); a dump
    pair gets ``w = 0``, as here, and ``r_lat = 0`` where the plain version
    has the prior's gradient at the dump position.  No consumer reads it:
    K4 drops the rows whose w is 0.  Each point's sums skip the dump pairs'
    terms, which are +-0, so they are what adding them in j order gives."""
    cpu = _check_inputs("pair_sdf_aggregate", table, idx_ext, x)
    profiling.hold_pairs("k3", idx_ext, table.shape[0] - 1)
    if cpu:
        return pair_sdf_aggregate_ref(table, idx_ext, x, layers, rbf)
    p, k = idx_ext.shape
    pt = torch.empty((p, 5), dtype=torch.float32, device=x.device)
    w = torch.empty((p * k,), dtype=torch.float32, device=x.device)
    r = torch.empty((p * k, LAT), dtype=torch.bfloat16, device=x.device)
    return _launch_agg("pair_sdf_aggregate", table, idx_ext, x, layers, rbf,
                       (pt, w, r))


def pair_sdf_aggregate_bwd_ref(num_bar, w, r_lat, idx_ext, n: int):
    """Plain K4: ``[n, 32]`` f32 with ``out[idx[t]] += (num_bar[t // k] *
    w[t]) * r_lat[t]`` over the pair rows t; a row whose index lies outside
    ``[0, n)`` (the dump row n) or whose w is 0 adds nothing."""
    k = idx_ext.shape[1]
    idx = idx_ext.reshape(-1).long()
    keep = (idx >= 0) & (idx < n) & (w != 0)
    ct = (torch.repeat_interleave(num_bar, k) * w)[:, None] * r_lat.float()
    out = torch.zeros((n + 1, r_lat.shape[1]), dtype=torch.float32,
                      device=w.device)
    out.index_add_(0, torch.where(keep, idx, n),
                   torch.where(keep[:, None], ct, 0.0))
    return out[:n]


def _check_bwd_inputs(num_bar, w, r_lat, idx_ext, n: int) -> bool:
    """K4's input checks; True when the tensors lie on the CPU.  They run
    on every training step's host path, so they read the cheapest
    attributes (``get_device`` is an int, ``device`` a new object)."""
    p, k = idx_ext.shape
    if num_bar.shape != (p,) or w.shape != (p * k,) or \
            r_lat.shape != (p * k, LAT):
        raise ValueError("pair_sdf_aggregate_bwd: num_bar [P], w [P*k] and "
                         f"r_lat [P*k, {LAT}] for idx_ext [P, k]")
    if w.is_cuda:
        d = w.get_device()
        same = num_bar.get_device() == d and r_lat.get_device() == d and \
            idx_ext.get_device() == d
    else:
        dev = w.device
        same = num_bar.device == dev and r_lat.device == dev and \
            idx_ext.device == dev
    if not same:
        raise ValueError("pair_sdf_aggregate_bwd: inputs on different "
                         "devices")
    if not w.is_cuda:
        if w.device.type == "cpu":
            return True
        raise ValueError(f"pair_sdf_aggregate_bwd: unsupported device "
                         f"{w.device}")
    if (num_bar.dtype, w.dtype, r_lat.dtype, idx_ext.dtype) != \
            (torch.float32, torch.float32, torch.bfloat16, torch.int32):
        raise ValueError("pair_sdf_aggregate_bwd: num_bar and w f32, r_lat "
                         "bf16, idx_ext int32")
    if n <= 0 or not (num_bar.is_contiguous() and w.is_contiguous() and
                      r_lat.is_contiguous() and idx_ext.is_contiguous()) \
            or r_lat.data_ptr() % 8:
        raise ValueError("pair_sdf_aggregate_bwd: contiguous inputs (r_lat "
                         "8-byte aligned), n > 0")
    return False


def pair_sdf_aggregate_bwd(num_bar, w, r_lat, idx_ext, n: int):
    """K4: the latent cotangent ``[n, 32]`` of K3's per-point ``sum_k w s``.

    num_bar ``[P]`` f32; w ``[P*k]`` f32 and r_lat ``[P*k, 32]`` (bf16 on
    the card) are K3's residuals; idx_ext ``[P, k]`` int32.  CPU tensors run
    :func:`pair_sdf_aggregate_bwd_ref`; CUDA tensors launch the kernel.
    Its wrapper is on every training step's host path, so it does the least
    host work it can: one CUDA launch (the kernel zeroes its output), and
    the stream read as its raw handle.
    """
    if _check_bwd_inputs(num_bar, w, r_lat, idx_ext, n):
        return pair_sdf_aggregate_bwd_ref(num_bar, w, r_lat, idx_ext, n)
    p, k = idx_ext.shape
    out = w.new_empty((n, LAT))
    err = cuda_build.load("agg_bwd", _SIG_BWD).pair_sdf_aggregate_bwd_launch(
        num_bar.data_ptr(), w.data_ptr(), r_lat.data_ptr(),
        idx_ext.data_ptr(), p * k, k, n, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(w.get_device()))
    cuda_build.check(err, "pair_sdf_aggregate_bwd")
    profiling.count("pair_sdf_aggregate_bwd")
    return out


class PairSdfAggregate(torch.autograd.Function):
    """``(num [P], den [P], gagg [P, 3])``: the RBF-aggregated prior SDF
    sums of K3, differentiable in the latents and in x.

    The VJP of ``spurfies_tpu/model/field.py:491-511``:
      * latents: K4 from K3's residuals w, r_lat and num's cotangent;
      * x: ``num_bar * gagg`` (the weights are constant in x: their
        distances are detached, reference pointneus_disent.py:242);
      * den's and gagg's cotangents are dropped.  den has no latent
        dependence, and gagg's latent derivative is zero almost everywhere
        (the frozen prior is piecewise linear), so the eikonal term puts
        exactly nothing into the latents, as in the JAX package.
    """

    @staticmethod
    def forward(ctx, latents, points, idx_ext, x, layers: PriorLayers,
                rbf: float):
        pt, w, r_lat = pair_sdf_aggregate(pair_table(latents, points),
                                          idx_ext, x.contiguous(), layers,
                                          rbf)
        gagg = pt[:, 2:5]
        ctx.save_for_backward(w, r_lat, idx_ext, gagg)
        ctx.n = latents.shape[0]
        return pt[:, 0], pt[:, 1], gagg

    @staticmethod
    def backward(ctx, num_bar, den_bar, gagg_bar):
        w, r_lat, idx_ext, gagg = ctx.saved_tensors
        lat_bar = x_bar = None
        if ctx.needs_input_grad[0]:
            lat_bar = pair_sdf_aggregate_bwd(num_bar.contiguous(), w, r_lat,
                                             idx_ext, ctx.n)
        if ctx.needs_input_grad[3]:
            x_bar = num_bar[:, None] * gagg
        return lat_bar, None, None, x_bar, None, None


# ------------------------------------------------ K6 / K7: per pair row ----

def pair_sdf_value_ref(u, layers: PriorLayers):
    """Plain K7b: ``s [M]`` from ``u [M, 35]``."""
    s, _ = _up_sweep(layers, _mm(u, layers.ws[0]) + layers.bs[0],
                     keep_gates=False)
    return s


def pair_sdf_value_and_input_grad_ref(u, layers: PriorLayers):
    """Plain K7a: ``(s [M], r [M, 35])``.  Its first layer is formed as
    plain K6a forms it, ``lat @ W_lat + x_pi @ W_pos`` (``_mlp_kernel``'s
    ``u @ W0`` up to f32 summation order), since K7a runs K6a's kernel:
    on ``u = [g_lat | x - g_pos]`` its s and r are plain K6a's bit for
    bit."""
    s, gates = _up_sweep(layers, _first_split(layers, u[:, :LAT],
                                              u[:, LAT:]), keep_gates=True)
    return s, _down_sweep(layers, gates, u.shape[0], u.device)


def pair_sdf_rows_value_ref(g, x, layers: PriorLayers):
    """Plain K6b: ``(s [M], x_pi [M, 3])`` with ``x_pi = x - g[:, 32:]``."""
    xpi = x - g[:, LAT:]
    s, _ = _up_sweep(layers, _first_split(layers, g[:, :LAT], xpi),
                     keep_gates=False)
    return s, xpi


def pair_sdf_rows_grad_ref(g, x, layers: PriorLayers):
    """Plain K6a: ``(s [M], r [M, 35], x_pi [M, 3])``."""
    xpi = x - g[:, LAT:]
    s, gates = _up_sweep(layers, _first_split(layers, g[:, :LAT], xpi),
                         keep_gates=True)
    return s, _down_sweep(layers, gates, g.shape[0], g.device), xpi


def _check_rows(name, *ins):
    """Inputs of the per-row kernels: f32, contiguous, ``[M, 35]`` then
    (K6) ``[M, 3]``, on one device."""
    m = ins[0].shape[0]
    for t, cols in zip(ins, (LAT + 3, 3)):
        if t.dtype != torch.float32 or tuple(t.shape) != (m, cols):
            raise ValueError(f"{name}: f32 [M, {LAT + 3}] rows and f32 "
                             f"[M, 3] queries, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.device != ins[0].device:
            raise ValueError(f"{name}: inputs on different devices")
    dev = ins[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{name}: contiguous inputs")
    return dev.type == "cpu"


def _launch_rows(name, entry, ins, layers: PriorLayers, out_cols):
    """Run the C entry ``entry`` on ``ins`` into new f32 outputs of
    ``[M, c]`` for each c of ``out_cols`` (0: ``[M]``), counted under
    ``name``: K6a, K6b, K7a and K7b, in ``csrc/sdf_agg.cu`` on
    :meth:`PriorLayers.k3_buffer`."""
    m = ins[0].shape[0]
    dev = ins[0].device
    outs = [torch.empty((m, c) if c else (m,), dtype=torch.float32,
                        device=dev) for c in out_cols]
    if m == 0:
        return outs
    bbuf = layers.bias_buffer()
    wbuf = layers.k3_buffer()
    lib = cuda_build.load("sdf_agg", _SIG_SDF_AGG)
    err = getattr(lib, entry)(
        *(t.data_ptr() for t in ins), m, wbuf.data_ptr(), bbuf.data_ptr(),
        *(t.data_ptr() for t in outs),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, name)
    profiling.count(name)
    return outs


@torch.no_grad()
def pair_sdf_value(u, layers: PriorLayers):
    """K7b: ``s [M]`` from ``u [M, 35]`` (no gradient).  CPU tensors run
    :func:`pair_sdf_value_ref`; CUDA tensors launch the kernel (bf16).  The
    kernel is K7a without the down sweep: its ``s`` is K7a's bit for bit."""
    if _check_rows("pair_sdf_value", u):
        return pair_sdf_value_ref(u, layers)
    return _launch_rows("pair_sdf_value", "pair_sdf_pre_value_launch", (u,),
                        layers, (0,))[0]


@torch.no_grad()
def pair_sdf_value_and_input_grad(u, layers: PriorLayers):
    """K7a, forward only (the differentiable form is
    :class:`PairSdfValueAndInputGrad`): ``(s [M], r [M, 35])``.  The kernel
    is K6a's with a gather that reads x_pi from u: on ``u = [g_lat | K6a's
    x_pi]`` its s and r are K6a's bit for bit."""
    if _check_rows("pair_sdf_value_and_input_grad", u):
        return pair_sdf_value_and_input_grad_ref(u, layers)
    return tuple(_launch_rows("pair_sdf_value_and_input_grad",
                              "pair_sdf_pre_grad_launch", (u,), layers,
                              (0, LAT + 3)))


@torch.no_grad()
def pair_sdf_rows_value(g, x, layers: PriorLayers):
    """K6b: ``(s [M], x_pi [M, 3])`` from rows ``g [M, 35]`` and queries
    ``x [M, 3]`` (no gradient: the sampler's probe).  The kernel is K6a
    without the down sweep: its ``s`` and ``x_pi`` are K6a's bit for bit."""
    if _check_rows("pair_sdf_rows_value", g, x):
        return pair_sdf_rows_value_ref(g, x, layers)
    return tuple(_launch_rows("pair_sdf_rows_value",
                              "pair_sdf_rows_value_launch", (g, x), layers,
                              (0, 3)))


@torch.no_grad()
def pair_sdf_rows_grad(g, x, layers: PriorLayers):
    """K6a, forward only (the differentiable form is
    :class:`PairSdfRowsGrad`): ``(s [M], r [M, 35], x_pi [M, 3])``."""
    if _check_rows("pair_sdf_rows_grad", g, x):
        return pair_sdf_rows_grad_ref(g, x, layers)
    return tuple(_launch_rows("pair_sdf_rows_grad",
                              "pair_sdf_rows_grad_launch", (g, x), layers,
                              (0, LAT + 3, 3)))


class PairSdfRowsGrad(torch.autograd.Function):
    """K6a, differentiable in ``g`` and ``x``: ``_gx_vjp_bwd``
    (``spurfies_tpu/ops/pallas_mlp.py:522-530``).  With ``u = [g_lat | x -
    g_pos]`` and ``sr = s_bar r``: ``g_bar = [sr_lat | -sr_pos - x_pi_bar]``,
    ``x_bar = sr_pos + x_pi_bar``.  ``r`` carries no gradient: its
    derivative is zero almost everywhere (the prior is piecewise linear)."""

    @staticmethod
    def forward(ctx, g, x, layers: PriorLayers):
        s, r, xpi = pair_sdf_rows_grad(g, x, layers)
        ctx.save_for_backward(r)
        ctx.mark_non_differentiable(r)
        return s, r, xpi

    @staticmethod
    def backward(ctx, s_bar, _r_bar, xpi_bar):
        r, = ctx.saved_tensors
        sr = s_bar[:, None] * r
        g_bar = torch.cat([sr[:, :LAT], -sr[:, LAT:] - xpi_bar], 1)
        return g_bar, sr[:, LAT:] + xpi_bar, None


class PairSdfValueAndInputGrad(torch.autograd.Function):
    """K7a, differentiable in ``u``: ``u_bar = s_bar r``
    (``spurfies_tpu/ops/pallas_mlp.py:473-478``); ``r`` carries no
    gradient, as in :class:`PairSdfRowsGrad`."""

    @staticmethod
    def forward(ctx, u, layers: PriorLayers):
        s, r = pair_sdf_value_and_input_grad(u, layers)
        ctx.save_for_backward(r)
        ctx.mark_non_differentiable(r)
        return s, r

    @staticmethod
    def backward(ctx, s_bar, _r_bar):
        r, = ctx.saved_tensors
        return s_bar[:, None] * r, None
