"""K8a / K8b: the fused colour MLP stack, forward and backward.

Port of ``spurfies_tpu/ops/pallas_color.py`` (``_color_fwd_call`` ->
``_color_fwd_kernel``, ``_color_bwd_call`` -> ``_color_bwd_kernel``): per
(point, neighbour) pair F_color (4 linears, 103 -> 256) on ``[posenc(x_pi)
| lat]``, the ``wn``-weighted sum over the k=8 neighbours, then per point
R (3 linears, 277 -> 3) on ``[dir_enc | agg]`` and a sigmoid.  It is the
fused branch of ``model.field.aggregate_color`` (``field.FUSED_COLOR``).

The CUDA kernels are ``csrc/color_mlp.cu``; ``*_ref`` are their plain
PyTorch versions (CPU tensors, and the kernels' yardstick on the card).
Both follow the TPU kernel's rounding points (``pallas_color.py:54-176``),
which are not ``model.networks.mlp_apply``'s: operands in the compute dtype
``dt`` with f32 accumulation, the bias added in f32 after the product, the
LeakyReLU ``max(a, 0.01 a)`` in f32 before the cast, F_color's last layer
rounded to ``dt`` before the f32 weighted sum, ``g = [dir_enc | agg]``
rounded, R's last layer f32 into the sigmoid.  The backward rounds each
delta to ``dt`` for each product, gates it with ``a > 0 ? 1 : 0.01`` and
sums ``db`` from the f32 delta.  K8b sums dW/db in a fixed order of its
own (split-K partials, then the splits and tiles in order; no atomics),
so two launches give the same bits, and it agrees with its plain version
up to f32 reordering there.

Weights are the trainable ``F_color`` / ``R`` lists of ``{"w": [in, out],
"b": [out]}`` f32 tensors.  Pair rows are point-major: ``x_pi``, ``lat``
and ``wn`` have ``8 P`` rows for ``P`` points.
"""

import ctypes

import torch

from spurfies_tpu_torch.core.embedder import positional_encoding
from spurfies_tpu_torch.ops import cuda_build
from spurfies_tpu_torch.ops.pair_mlp import _swizzle128

PK = 8                  # neighbours per point
POS_MULTIRES = 6        # posenc(x_pi) -> 39 columns
LAT = 64
DIR = 21                # viewenc(dir), multires 3
HID = 256
N_F, N_R = 4, 3
F_SHAPES = ((39 + LAT, HID), (HID, HID), (HID, HID), (HID, HID))
R_SHAPES = ((DIR + HID, HID), (HID, HID), (HID, 3))
N_GRADS = sum(i * o + o for i, o in F_SHAPES + R_SHAPES)     # 361,731
G_COLS = 320            # K8a's g rows: [dir_enc | agg | 0], 5 blocks of 64
# The packed weights (csrc/color_mlp.cu, wg::pack_segs): 46 chunks of
# 16,384 bf16, each the image of the ring stage that a product reads:
# (chunk, layer of F_color + R, transposed, rows, columns, first row).  A
# transposed entry is W^T [out, in] (the forward products), else W [in,
# out] from its first row (the reverse products); zero-padded to (rows,
# columns), then _swizzle128'd.
PACK_CHUNK = 16384
PACK_CHUNKS = 46
PACK = ((0, 0, True, HID, 128, 0), (2, 1, True, HID, HID, 0),
        (6, 2, True, HID, HID, 0), (10, 3, True, HID, HID, 0),
        (14, 4, True, HID, 320, 0), (19, 5, True, HID, HID, 0),
        (23, 6, True, 8, HID, 0), (24, 6, False, HID, 64, 0),
        (25, 5, False, HID, HID, 0), (29, 4, False, HID, HID, DIR),
        (33, 3, False, HID, HID, 0), (37, 2, False, HID, HID, 0),
        (41, 1, False, HID, HID, 0), (45, 0, False, LAT, HID, 39))

LAUNCHES = {"pack_color_weights": 0, "fused_color_fwd": 0,
            "fused_color_bwd": 0}

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_LL = ctypes.c_longlong
_SIG = {"color_pack_launch": [_PP, _P, _P],
        "fused_color_fwd_launch": [_P, _P, _P, _P, _LL, _P, _PP, _P, _P, _P],
        "fused_color_bwd_launch": [_P, _P, _P, _P, _LL, _P, _PP, _P, _P, _P,
                                   _P, _P],
        "fused_color_bwd_scratch_bytes": [_LL]}


def _mm(a, w, dt):
    """Product of ``dt`` operands accumulated in f32 (with TF32 off, an f32
    matmul of rounded operands is that product on the CPU and the card)."""
    return a.to(dt).float() @ w.to(dt).float()


def _gate(pre):
    return torch.where(pre > 0, 1.0, 0.01)


def pair_half_ref(x_pi, lat, wn, dir_enc, f_color, dt):
    """The pair half of ``_fwd_body`` (``pallas_color.py:54-75``): F_color
    per pair, the wn-sum per point, ``g = dt([dir_enc | agg])``; returns
    ``(g [P, 277], residuals)``.  The kernels split the stack here, where
    the TPU body rounds."""
    u = torch.cat([positional_encoding(x_pi, POS_MULTIRES), lat], -1)
    h = u.to(dt)
    fw_in, f_pre = [], []
    for i, layer in enumerate(f_color):
        fw_in.append(h)
        a = _mm(h, layer["w"], dt) + layer["b"].float()
        if i < len(f_color) - 1:
            f_pre.append(a)
            h = torch.maximum(a, 0.01 * a).to(dt)
        else:
            h = a.to(dt)
    p = dir_enc.shape[0]
    agg = (h.float() * wn[:, None]).reshape(p, PK, -1).sum(1)
    return torch.cat([dir_enc, agg], -1).to(dt), (fw_in, f_pre)


def point_half_ref(g, r, dt):
    """The point half of ``_fwd_body`` (``pallas_color.py:76-89``): R on
    ``g`` and the sigmoid; returns ``(rgb [P, 3], residuals)``."""
    r_in, r_pre = [], []
    for i, layer in enumerate(r):
        r_in.append(g)
        a = _mm(g, layer["w"], dt) + layer["b"].float()
        if i < len(r) - 1:
            r_pre.append(a)
            g = torch.maximum(a, 0.01 * a).to(dt)
        else:
            g = a
    return torch.sigmoid(g), (r_in, r_pre)


def _fwd_body(x_pi, lat, wn, dir_enc, f_color, r, dt):
    """``_fwd_body`` of ``pallas_color.py:54-89``: rgb and the residuals of
    the reverse sweeps, the pair half then the point half."""
    g, (fw_in, f_pre) = pair_half_ref(x_pi, lat, wn, dir_enc, f_color, dt)
    rgb, (r_in, r_pre) = point_half_ref(g, r, dt)
    return rgb, (fw_in, f_pre, r_in, r_pre)


def fused_color_fwd_ref(x_pi, lat, wn, dir_enc, f_color, r, dt, packed=None):
    """Plain K8a: rgb ``[P, 3]`` f32 (``packed``, the kernels' weights, is
    not read: the plain version rounds the f32 weights itself)."""
    return _fwd_body(x_pi, lat, wn, dir_enc, f_color, r, dt)[0]


def point_bwd_ref(g, r, rgb_bar, dt):
    """The point kernel's part of ``_color_bwd_kernel``
    (``pallas_color.py:135-151``): R forward on ``g`` and its reverse sweep.
    Returns ``(d_agg [P, 256] f32, R's inputs, R's f32 deltas)``."""
    rgb, (r_in, r_pre) = point_half_ref(g, r, dt)
    deltas = [None] * N_R
    delta = rgb_bar * rgb * (1.0 - rgb)
    for i in range(N_R - 1, -1, -1):
        deltas[i] = delta
        delta = _mm(delta, r[i]["w"].t(), dt)
        if i > 0:
            delta = delta * _gate(r_pre[i - 1])
    return delta[:, DIR:], r_in, deltas


def pair_bwd_ref(d_agg, wn, f_color, f_pre, dt):
    """The reverse pair kernel's part (``pallas_color.py:152-176``):
    delta_F3 = wn d_agg[point], the sweep through F_color.  Returns ``(dlat
    [8P, 64], F_color's f32 deltas)``."""
    deltas = [None] * N_F
    delta = torch.repeat_interleave(d_agg, PK, 0) * wn[:, None]
    for i in range(N_F - 1, -1, -1):
        deltas[i] = delta
        delta = _mm(delta, f_color[i]["w"].t(), dt)
        if i > 0:
            delta = delta * _gate(f_pre[i - 1])
    return delta[:, -LAT:], deltas


def dw_split_ref(x, delta, splits, dt):
    """Plain split-K product ``x^T delta`` as the dW kernel sums it: the rows
    in ``splits`` ranges of a whole number of 32-row chunks, each range's
    ``_mm`` then the ranges added in order."""
    rows = x.shape[0]
    per = -(-(-(-rows // splits)) // 32) * 32
    out = None
    for s in range(splits):
        part = _mm(x[s * per:(s + 1) * per].t(), delta[s * per:(s + 1) * per],
                   dt)
        out = part if out is None else out + part
    return out


def fused_color_bwd_ref(x_pi, lat, wn, dir_enc, f_color, r, rgb_bar, dt,
                        packed=None):
    """Plain K8b (``_color_bwd_kernel``, ``pallas_color.py:108-176``):
    ``(dlat [8P, 64], dws, dbs)``, dws the 7 weight gradients ``[in, out]``
    and dbs the 7 bias gradients ``[out]`` of F_color then R, all f32
    (``packed`` is not read)."""
    g, (fw_in, f_pre) = pair_half_ref(x_pi, lat, wn, dir_enc, f_color, dt)
    d_agg, r_in, r_deltas = point_bwd_ref(g, r, rgb_bar, dt)
    dlat, f_deltas = pair_bwd_ref(d_agg, wn, f_color, f_pre, dt)
    ins, deltas = fw_in + r_in, f_deltas + r_deltas
    dws = [_mm(x.t(), d, dt) for x, d in zip(ins, deltas)]
    dbs = [d.sum(0) for d in deltas]
    return dlat, dws, dbs


def _net_inputs(name, f_color, r):
    """(label, tensor, shape) of every weight and bias of F_color and R."""
    ins = []
    for layers, shapes, net in ((f_color, F_SHAPES, "F_color"),
                                (r, R_SHAPES, "R")):
        if len(layers) != len(shapes):
            raise ValueError(f"{name}: {net} must have {len(shapes)} layers")
        for i, (layer, (fi, fo)) in enumerate(zip(layers, shapes)):
            ins += [(f"{net}[{i}].w", layer["w"], (fi, fo)),
                    (f"{net}[{i}].b", layer["b"], (fo,))]
    return ins


def _check(name, x_pi, lat, wn, dir_enc, f_color, r, rgb_bar=None):
    """Inputs of K8: f32, shapes of ModelConfig's colour nets, one device;
    on the card, contiguous.  Returns True for CPU tensors."""
    p = dir_enc.shape[0]
    ins = [("x_pi", x_pi, (PK * p, 3)), ("lat", lat, (PK * p, LAT)),
           ("wn", wn, (PK * p,)), ("dir_enc", dir_enc, (p, DIR))]
    if rgb_bar is not None:
        ins.append(("rgb_bar", rgb_bar, (p, 3)))
    ins += _net_inputs(name, f_color, r)
    dev = ins[0][1].device
    for label, t, shape in ins:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be f32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for _, t, _ in ins):
        raise ValueError(f"{name}: contiguous inputs")
    return dev.type == "cpu"


def _pointers(f_color, r):
    ws = (ctypes.c_void_p * (N_F + N_R))(
        *(layer["w"].data_ptr() for layer in list(f_color) + list(r)))
    bs = (ctypes.c_void_p * (N_F + N_R))(
        *(layer["b"].data_ptr() for layer in list(f_color) + list(r)))
    return ws, bs


def pack_color_weights_ref(f_color, r):
    """Plain pack: the ``PACK`` images composed with ``_swizzle128``, bf16
    ``[PACK_CHUNKS * PACK_CHUNK]`` (unused tails of a chunk zero)."""
    ws = [layer["w"] for layer in list(f_color) + list(r)]
    out = ws[0].new_zeros(PACK_CHUNKS * PACK_CHUNK, dtype=torch.bfloat16)
    for chunk, layer, trans, rows, cols, row0 in PACK:
        w = ws[layer].t() if trans else ws[layer][row0:row0 + rows]
        b = w.new_zeros(rows, cols)
        b[:w.shape[0], :w.shape[1]] = w
        img = _swizzle128(b.to(torch.bfloat16))
        out[chunk * PACK_CHUNK:chunk * PACK_CHUNK + img.numel()] = img
    return out


@torch.no_grad()
def pack_color_weights(f_color, r):
    """The colour kernels' weights, rounded to bf16 and packed once (per
    step: ``FusedColor`` packs in its forward and keeps the result for its
    backward), bf16 ``[PACK_CHUNKS * PACK_CHUNK]``.  CPU tensors run
    :func:`pack_color_weights_ref`; CUDA tensors launch the pack kernel."""
    ins = _net_inputs("pack_color_weights", f_color, r)
    dev = ins[0][1].device
    for label, t, shape in ins:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"pack_color_weights: {label} must be f32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("pack_color_weights: weights on different "
                             "devices")
    if dev.type == "cpu":
        return pack_color_weights_ref(f_color, r)
    if dev.type != "cuda" or not all(t.is_contiguous() for _, t, _ in ins):
        raise ValueError("pack_color_weights: contiguous CUDA or CPU weights")
    out = torch.empty(PACK_CHUNKS * PACK_CHUNK, dtype=torch.bfloat16,
                      device=dev)
    ws, _ = _pointers(f_color, r)
    err = _lib().color_pack_launch(ws, out.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "pack_color_weights")
    LAUNCHES["pack_color_weights"] += 1
    return out


def _lib():
    """The kernels' library, built on first use."""
    lib = cuda_build.load("color_mlp", _SIG)
    lib.fused_color_bwd_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _need_bf16(name, dt):
    if dt != torch.bfloat16:
        raise ValueError(f"{name}: the colour kernels run in bf16 only; got "
                         f"{dt}")


def _check_packed(name, packed, dev):
    if packed.dtype != torch.bfloat16 or packed.device != dev or \
            tuple(packed.shape) != (PACK_CHUNKS * PACK_CHUNK,) or \
            not packed.is_contiguous():
        raise ValueError(f"{name}: packed must be pack_color_weights' "
                         "output on the inputs' device")


@torch.no_grad()
def fused_color_fwd(x_pi, lat, wn, dir_enc, f_color, r, dt, packed=None):
    """K8a: rgb ``[P, 3]`` f32 (forward only; the differentiable form is
    :class:`FusedColor`).  CPU tensors run :func:`fused_color_fwd_ref`;
    CUDA tensors launch the pair and point kernels (``dt`` bf16 only) on
    ``packed`` (:func:`pack_color_weights` of the same nets; packed here
    when None)."""
    if _check("fused_color_fwd", x_pi, lat, wn, dir_enc, f_color, r):
        return fused_color_fwd_ref(x_pi, lat, wn, dir_enc, f_color, r, dt)
    _need_bf16("fused_color_fwd", dt)
    p = dir_enc.shape[0]
    dev = x_pi.device
    rgb = torch.empty((p, 3), dtype=torch.float32, device=dev)
    if p == 0:
        return rgb
    if packed is None:
        packed = pack_color_weights(f_color, r)
    _check_packed("fused_color_fwd", packed, dev)
    g = torch.empty((p, G_COLS), dtype=torch.bfloat16, device=dev)
    _, bs = _pointers(f_color, r)
    err = _lib().fused_color_fwd_launch(
        x_pi.data_ptr(), lat.data_ptr(), wn.data_ptr(), dir_enc.data_ptr(), p,
        packed.data_ptr(), bs, g.data_ptr(), rgb.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "fused_color_fwd")
    LAUNCHES["fused_color_fwd"] += 1
    return rgb


@torch.no_grad()
def fused_color_bwd(x_pi, lat, wn, dir_enc, f_color, r, rgb_bar, dt,
                    packed=None):
    """K8b: ``(dlat [8P, 64], dws, dbs)`` for the cotangent ``rgb_bar
    [P, 3]``.  CPU tensors run :func:`fused_color_bwd_ref`; CUDA tensors
    launch the kernels (``dt`` bf16 only) on ``packed`` (the forward's
    :func:`pack_color_weights`; packed here when None), with a scratch of
    about 3.9 KB a pair row: the layers' bf16 inputs and deltas for the
    split-K dW product, and the f32 partial sums."""
    if _check("fused_color_bwd", x_pi, lat, wn, dir_enc, f_color, r,
              rgb_bar):
        return fused_color_bwd_ref(x_pi, lat, wn, dir_enc, f_color, r,
                                   rgb_bar, dt)
    _need_bf16("fused_color_bwd", dt)
    p = dir_enc.shape[0]
    dev = x_pi.device
    dlat = torch.empty((PK * p, LAT), dtype=torch.float32, device=dev)
    grads = (torch.empty if p > 0 else torch.zeros)(
        (N_GRADS,), dtype=torch.float32, device=dev)
    if p > 0:
        if packed is None:
            packed = pack_color_weights(f_color, r)
        _check_packed("fused_color_bwd", packed, dev)
        lib = _lib()
        scratch = torch.empty((lib.fused_color_bwd_scratch_bytes(p),),
                              dtype=torch.uint8, device=dev)
        _, bs = _pointers(f_color, r)
        err = lib.fused_color_bwd_launch(
            x_pi.data_ptr(), lat.data_ptr(), wn.data_ptr(),
            dir_enc.data_ptr(), p, packed.data_ptr(), bs, rgb_bar.data_ptr(),
            dlat.data_ptr(), grads.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(err, "fused_color_bwd")
        LAUNCHES["fused_color_bwd"] += 1
    shapes = F_SHAPES + R_SHAPES
    dws, off = [], 0
    for fi, fo in shapes:
        dws.append(grads[off:off + fi * fo].view(fi, fo))
        off += fi * fo
    dbs = []
    for _, fo in shapes:
        dbs.append(grads[off:off + fo])
        off += fo
    return dlat, dws, dbs


def _nets(wb):
    """The flat ``(w, b, w, b, ...)`` of F_color then R as layer lists."""
    layers = [{"w": wb[2 * i], "b": wb[2 * i + 1]} for i in range(N_F + N_R)]
    return layers[:N_F], layers[N_F:]


class FusedColor(torch.autograd.Function):
    """rgb ``[P, 3]`` from the pair inputs: K8a forward, K8b backward
    (``fused_color``'s custom VJP, ``pallas_color.py:283-330``).

    It saves its inputs and the packed weights (one pack a step); the
    backward recomputes the forward, as the TPU kernel does.  Gradients go to ``lat`` and to every weight and bias
    of F_color and R.  x_pi, wn and dir_enc get none (the JAX VJP returns
    zeros there): the shading points are detached in the renderer
    (``model/renderer.py``, ``z_all.detach()``), and the RBF weights and
    the view directions carry no parameter.
    """

    @staticmethod
    def forward(ctx, x_pi, lat, wn, dir_enc, dt, *wb):
        packed = pack_color_weights(*_nets(wb))
        ctx.save_for_backward(x_pi, lat, wn, dir_enc, packed, *wb)
        ctx.dt = dt
        return fused_color_fwd(x_pi, lat, wn, dir_enc, *_nets(wb), dt,
                               packed=packed)

    @staticmethod
    def backward(ctx, rgb_bar):
        x_pi, lat, wn, dir_enc, packed, *wb = ctx.saved_tensors
        dlat, dws, dbs = fused_color_bwd(x_pi, lat, wn, dir_enc, *_nets(wb),
                                         rgb_bar.contiguous(), ctx.dt,
                                         packed=packed)
        grads = [g for pair in zip(dws, dbs) for g in pair]
        return (None, dlat, None, None, None, *grads)


def fused_color(f_color, r, x_pi, lat, wn, dir_enc, dt):
    """rgb ``[P, 3]`` through :class:`FusedColor`, differentiable in
    ``lat`` and in the F_color / R lists' tensors."""
    wb = [t for layer in list(f_color) + list(r) for t in (layer["w"],
                                                           layer["b"])]
    return FusedColor.apply(x_pi, lat, wn, dir_enc, dt, *wb)
