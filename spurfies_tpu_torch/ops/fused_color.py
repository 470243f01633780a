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
sums ``db`` from the f32 delta.  K8b adds every block's dW/db with
atomics, so it agrees with its plain version up to f32 reordering there.

Weights are the trainable ``F_color`` / ``R`` lists of ``{"w": [in, out],
"b": [out]}`` f32 tensors.  Pair rows are point-major: ``x_pi``, ``lat``
and ``wn`` have ``8 P`` rows for ``P`` points.
"""

import ctypes

import torch

from spurfies_tpu_torch.core.embedder import positional_encoding
from spurfies_tpu_torch.ops import cuda_build

PK = 8                  # neighbours per point
POS_MULTIRES = 6        # posenc(x_pi) -> 39 columns
LAT = 64
DIR = 21                # viewenc(dir), multires 3
HID = 256
N_F, N_R = 4, 3
F_SHAPES = ((39 + LAT, HID), (HID, HID), (HID, HID), (HID, HID))
R_SHAPES = ((DIR + HID, HID), (HID, HID), (HID, 3))
_PTS = 16               # points per CUDA block
_SCRATCH = 3 * HID      # K8b's stored layer inputs per pair row (bf16)
N_GRADS = sum(i * o + o for i, o in F_SHAPES + R_SHAPES)     # 361,731

LAUNCHES = {"fused_color_fwd": 0, "fused_color_bwd": 0}

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_LL = ctypes.c_longlong
_SIG = {"fused_color_fwd_launch": [_P, _P, _P, _P, _LL, _PP, _PP, _P, _P],
        "fused_color_bwd_launch": [_P, _P, _P, _P, _LL, _PP, _PP, _P, _P, _P,
                                   _P, _P]}


def _mm(a, w, dt):
    """Product of ``dt`` operands accumulated in f32 (with TF32 off, an f32
    matmul of rounded operands is that product on the CPU and the card)."""
    return a.to(dt).float() @ w.to(dt).float()


def _gate(pre):
    return torch.where(pre > 0, 1.0, 0.01)


def _fwd_body(x_pi, lat, wn, dir_enc, f_color, r, dt):
    """``_fwd_body`` of ``pallas_color.py:54-89``: rgb and the residuals of
    the reverse sweeps."""
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
    g = torch.cat([dir_enc, agg], -1).to(dt)
    r_in, r_pre = [], []
    for i, layer in enumerate(r):
        r_in.append(g)
        a = _mm(g, layer["w"], dt) + layer["b"].float()
        if i < len(r) - 1:
            r_pre.append(a)
            g = torch.maximum(a, 0.01 * a).to(dt)
        else:
            g = a
    return torch.sigmoid(g), (fw_in, f_pre, r_in, r_pre)


def fused_color_fwd_ref(x_pi, lat, wn, dir_enc, f_color, r, dt):
    """Plain K8a: rgb ``[P, 3]`` f32."""
    return _fwd_body(x_pi, lat, wn, dir_enc, f_color, r, dt)[0]


def fused_color_bwd_ref(x_pi, lat, wn, dir_enc, f_color, r, rgb_bar, dt):
    """Plain K8b (``_color_bwd_kernel``, ``pallas_color.py:108-176``):
    ``(dlat [8P, 64], dws, dbs)``, dws the 7 weight gradients ``[in, out]``
    and dbs the 7 bias gradients ``[out]`` of F_color then R, all f32."""
    rgb, (fw_in, f_pre, r_in, r_pre) = _fwd_body(x_pi, lat, wn, dir_enc,
                                                 f_color, r, dt)
    dws, dbs = [None] * (N_F + N_R), [None] * (N_F + N_R)
    delta = rgb_bar * rgb * (1.0 - rgb)
    for i in range(N_R - 1, -1, -1):
        dws[N_F + i] = _mm(r_in[i].t(), delta, dt)
        dbs[N_F + i] = delta.sum(0)
        delta = _mm(delta, r[i]["w"].t(), dt)
        if i > 0:
            delta = delta * _gate(r_pre[i - 1])
    d_agg = delta[:, DIR:]
    delta = torch.repeat_interleave(d_agg, PK, 0) * wn[:, None]
    for i in range(N_F - 1, -1, -1):
        dws[i] = _mm(fw_in[i].t(), delta, dt)
        dbs[i] = delta.sum(0)
        delta = _mm(delta, f_color[i]["w"].t(), dt)
        if i > 0:
            delta = delta * _gate(f_pre[i - 1])
    return delta[:, -LAT:], dws, dbs


def _check(name, x_pi, lat, wn, dir_enc, f_color, r, rgb_bar=None):
    """Inputs of K8: f32, shapes of ModelConfig's colour nets, one device;
    on the card, contiguous.  Returns True for CPU tensors."""
    p = dir_enc.shape[0]
    ins = [("x_pi", x_pi, (PK * p, 3)), ("lat", lat, (PK * p, LAT)),
           ("wn", wn, (PK * p,)), ("dir_enc", dir_enc, (p, DIR))]
    if rgb_bar is not None:
        ins.append(("rgb_bar", rgb_bar, (p, 3)))
    for layers, shapes, net in ((f_color, F_SHAPES, "F_color"),
                                (r, R_SHAPES, "R")):
        if len(layers) != len(shapes):
            raise ValueError(f"{name}: {net} must have {len(shapes)} layers")
        for i, (layer, (fi, fo)) in enumerate(zip(layers, shapes)):
            ins += [(f"{net}[{i}].w", layer["w"], (fi, fo)),
                    (f"{net}[{i}].b", layer["b"], (fo,))]
    dev = x_pi.device
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


def _need_bf16(name, dt):
    if dt != torch.bfloat16:
        raise ValueError(f"{name}: the colour kernels run in bf16 only; got "
                         f"{dt}")


@torch.no_grad()
def fused_color_fwd(x_pi, lat, wn, dir_enc, f_color, r, dt):
    """K8a: rgb ``[P, 3]`` f32 (forward only; the differentiable form is
    :class:`FusedColor`).  CPU tensors run :func:`fused_color_fwd_ref`;
    CUDA tensors launch the kernel (``dt`` bf16 only)."""
    if _check("fused_color_fwd", x_pi, lat, wn, dir_enc, f_color, r):
        return fused_color_fwd_ref(x_pi, lat, wn, dir_enc, f_color, r, dt)
    _need_bf16("fused_color_fwd", dt)
    p = dir_enc.shape[0]
    rgb = torch.empty((p, 3), dtype=torch.float32, device=x_pi.device)
    if p == 0:
        return rgb
    ws, bs = _pointers(f_color, r)
    lib = cuda_build.load("color_mlp", _SIG)
    err = lib.fused_color_fwd_launch(
        x_pi.data_ptr(), lat.data_ptr(), wn.data_ptr(), dir_enc.data_ptr(), p,
        ws, bs, rgb.data_ptr(),
        torch.cuda.current_stream(x_pi.device).cuda_stream)
    cuda_build.check(err, "fused_color_fwd")
    LAUNCHES["fused_color_fwd"] += 1
    return rgb


@torch.no_grad()
def fused_color_bwd(x_pi, lat, wn, dir_enc, f_color, r, rgb_bar, dt):
    """K8b: ``(dlat [8P, 64], dws, dbs)`` for the cotangent ``rgb_bar
    [P, 3]``.  CPU tensors run :func:`fused_color_bwd_ref`; CUDA tensors
    launch the kernel (``dt`` bf16 only), which needs a bf16 scratch of
    768 values per pair row for the inputs of F_color's layers 1-3."""
    if _check("fused_color_bwd", x_pi, lat, wn, dir_enc, f_color, r,
              rgb_bar):
        return fused_color_bwd_ref(x_pi, lat, wn, dir_enc, f_color, r,
                                   rgb_bar, dt)
    _need_bf16("fused_color_bwd", dt)
    p = dir_enc.shape[0]
    dev = x_pi.device
    dlat = torch.empty((PK * p, LAT), dtype=torch.float32, device=dev)
    grads = torch.zeros((N_GRADS,), dtype=torch.float32, device=dev)
    if p > 0:
        blocks = -(-p // _PTS)
        scratch = torch.empty((blocks * _PTS * PK * _SCRATCH,),
                              dtype=torch.bfloat16, device=dev)
        ws, bs = _pointers(f_color, r)
        lib = cuda_build.load("color_mlp", _SIG)
        err = lib.fused_color_bwd_launch(
            x_pi.data_ptr(), lat.data_ptr(), wn.data_ptr(),
            dir_enc.data_ptr(), p, ws, bs, rgb_bar.data_ptr(),
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

    It saves only its inputs; the backward recomputes the forward, as the
    TPU kernel does.  Gradients go to ``lat`` and to every weight and bias
    of F_color and R.  x_pi, wn and dir_enc get none (the JAX VJP returns
    zeros there): the shading points are detached in the renderer
    (``model/renderer.py``, ``z_all.detach()``), and the RBF weights and
    the view directions carry no parameter.
    """

    @staticmethod
    def forward(ctx, x_pi, lat, wn, dir_enc, dt, *wb):
        ctx.save_for_backward(x_pi, lat, wn, dir_enc, *wb)
        ctx.dt = dt
        return fused_color_fwd(x_pi, lat, wn, dir_enc, *_nets(wb), dt)

    @staticmethod
    def backward(ctx, rgb_bar):
        x_pi, lat, wn, dir_enc, *wb = ctx.saved_tensors
        dlat, dws, dbs = fused_color_bwd(x_pi, lat, wn, dir_enc, *_nets(wb),
                                         rgb_bar.contiguous(), ctx.dt)
        grads = [g for pair in zip(dws, dbs) for g in pair]
        return (None, dlat, None, None, None, *grads)


def fused_color(f_color, r, x_pi, lat, wn, dir_enc, dt):
    """rgb ``[P, 3]`` through :class:`FusedColor`, differentiable in
    ``lat`` and in the F_color / R lists' tensors."""
    wb = [t for layer in list(f_color) + list(r) for t in (layer["w"],
                                                           layer["b"])]
    return FusedColor.apply(x_pi, lat, wn, dir_enc, dt, *wb)
