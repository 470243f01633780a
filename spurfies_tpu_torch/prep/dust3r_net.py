"""DUSt3R-style two-view stereo network (port of
``spurfies_tpu/prep/dust3r_net.py``, the CroCo architecture).

Architecture (CroCo v2 / DUSt3R lineage), as the JAX package has it:
  * patch embed 16x16 conv, no cls token;
  * encoder: 24 x [LN -> RoPE2D-MHA -> LN -> GELU-MLP(4x)], dim 1024/16h;
  * decoder: embed 1024->768, 12 x [self-attn (RoPE2D) -> cross-attn to the
    other view's tokens -> MLP], separate weight sets per view;
  * linear head: per-patch Linear(768 -> 16*16*4) -> unshuffle -> [H, W, 4]
    = xyz + confidence; exp-mode postprocess (conf = 1 + exp(c)).

The parameter tree mirrors the JAX package's (``{"q", "k", "v", "proj"}``
attention dicts, ``ln1``/``ln2``/``ln_cross``/``ln_ctx``), in PyTorch's
layouts: a Linear's weight is ``[out, in]`` (``F.linear``), the patch
embedding's kernel ``[out, 3, p, p]`` (``F.conv2d`` on NCHW).  The JAX
package keeps ``[in, out]`` and HWIO; ``convert.from_jax.dust3r_from_jax``
carries its tree across.  The JAX package computes attention as a plain
einsum and softmax (no Pallas kernel is on this path), and so does the
port: ``torch.matmul`` and ``softmax``.

Precision: f32 with TF32 off for both the products and cuDNN's convolution
(:func:`infer_pair` turns both off for its call and restores them), so the
card's pointmaps are the CPU's up to the sum order.

There is no released checkpoint in the repository: :func:`convert_dust3r`
reads the upstream key layout (fused ``qkv``, ``projq``/``projk``/``projv``,
``norm3`` -> ``ln_cross``, ``norm_y`` -> ``ln_ctx``) as the JAX package's
converter does, and parity with the upstream model waits for that file.
"""

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from spurfies_tpu_torch.model.networks import ParamTree


@dataclasses.dataclass(frozen=True)
class Dust3rConfig:
    img_size: tuple = (384, 512)   # (H, W)
    patch: int = 16
    enc_dim: int = 1024
    enc_depth: int = 24
    enc_heads: int = 16
    dec_dim: int = 768
    dec_depth: int = 12
    dec_heads: int = 12
    rope_freq: float = 100.0

    @property
    def grid(self):
        return (self.img_size[0] // self.patch,
                self.img_size[1] // self.patch)

    @property
    def n_tokens(self):
        gh, gw = self.grid
        return gh * gw


# ---------------------------------------------------------------------------
# RoPE2D
# ---------------------------------------------------------------------------

def rope2d_angles(positions: torch.Tensor, head_dim: int,
                  freq: float = 100.0):
    """cos/sin tables for 2D rotary embedding.

    positions: ``[N, 2]`` (y, x) patch coordinates.  The first half of the
    rotated pairs turns by y, the second by x, each with ``head_dim // 4``
    frequencies.  Returns (cos ``[N, head_dim // 2]``, sin).
    """
    d4 = head_dim // 4
    inv = 1.0 / (freq ** (torch.arange(d4, dtype=torch.float32,
                                       device=positions.device) / d4))
    ang = torch.cat([positions[:, 0:1] * inv[None],
                     positions[:, 1:2] * inv[None]], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate the interleaved pairs ``(x[2i], x[2i+1])`` by the i-th angle.

    x: ``[..., N, D]`` with D = 2 * cos.shape[-1].
    """
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def layer_norm(p, x, eps=1e-6):
    """LayerNorm with the biased variance and ``eps`` inside the rsqrt."""
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], eps)


def linear(p, x):
    return F.linear(x, p["w"], p["b"])


def attention(p, xq, xkv, heads, rope_q=None, rope_k=None):
    """MHA; optional rotary embedding on q and k.

    xq: ``[Nq, D]``; xkv: ``[Nk, D]``; rope_*: (cos, sin) tables.
    """
    nq, d = xq.shape
    nk = xkv.shape[0]
    hd = d // heads
    q = linear(p["q"], xq).reshape(nq, heads, hd).transpose(0, 1)
    k = linear(p["k"], xkv).reshape(nk, heads, hd).transpose(0, 1)
    v = linear(p["v"], xkv).reshape(nk, heads, hd).transpose(0, 1)
    if rope_q is not None:
        q = apply_rope(q, *rope_q)
    if rope_k is not None:
        k = apply_rope(k, *rope_k)
    att = torch.softmax(torch.matmul(q, k.transpose(1, 2)) / math.sqrt(hd),
                        dim=-1)
    out = torch.matmul(att, v).transpose(0, 1).reshape(nq, d)
    return linear(p["proj"], out)


def mlp_block(p, x):
    # jax.nn.gelu's default is the tanh approximation
    return linear(p["fc2"], F.gelu(linear(p["fc1"], x), approximate="tanh"))


def enc_block(p, x, rope, heads):
    h = layer_norm(p["ln1"], x)
    x = x + attention(p["attn"], h, h, heads, rope_q=rope, rope_k=rope)
    return x + mlp_block(p["mlp"], layer_norm(p["ln2"], x))


def dec_block(p, x, ctx, rope, rope_ctx, heads):
    h = layer_norm(p["ln1"], x)
    x = x + attention(p["attn"], h, h, heads, rope_q=rope, rope_k=rope)
    x = x + attention(p["cross"], layer_norm(p["ln_cross"], x),
                      layer_norm(p["ln_ctx"], ctx), heads,
                      rope_q=rope, rope_k=rope_ctx)
    return x + mlp_block(p["mlp"], layer_norm(p["ln2"], x))


def patchify(params, img, cfg):
    """img ``[H, W, 3]`` -> tokens ``[N, enc_dim]`` (row-major over the
    patch grid) via the strided conv."""
    pe = params["patch_embed"]
    x = F.conv2d(img.permute(2, 0, 1)[None], pe["w"], pe["b"],
                 stride=cfg.patch)
    return x[0].flatten(1).transpose(0, 1)


def _positions(cfg, device):
    gh, gw = cfg.grid
    yy, xx = np.mgrid[0:gh, 0:gw]
    return torch.from_numpy(
        np.stack([yy, xx], -1).reshape(-1, 2).astype(np.float32)).to(device)


def encode(params, img, cfg: Dust3rConfig):
    rope = rope2d_angles(_positions(cfg, img.device),
                         cfg.enc_dim // cfg.enc_heads, cfg.rope_freq)
    x = patchify(params, img, cfg)
    for blk in params["enc_blocks"]:
        x = enc_block(blk, x, rope, cfg.enc_heads)
    return layer_norm(params["enc_norm"], x)


def decode_pair(params, feat1, feat2, cfg: Dust3rConfig):
    """Both streams step from the previous pair of states."""
    rope = rope2d_angles(_positions(cfg, feat1.device),
                         cfg.dec_dim // cfg.dec_heads, cfg.rope_freq)
    x1 = linear(params["decoder_embed"], feat1)
    x2 = linear(params["decoder_embed"], feat2)
    for b1, b2 in zip(params["dec_blocks"], params["dec_blocks2"]):
        x1, x2 = (dec_block(b1, x1, x2, rope, rope, cfg.dec_heads),
                  dec_block(b2, x2, x1, rope, rope, cfg.dec_heads))
    return (layer_norm(params["dec_norm"], x1),
            layer_norm(params["dec_norm"], x2))


def head(p, tokens, cfg):
    """Per-patch linear head -> (pts ``[H, W, 3]``, conf ``[H, W]``): the
    linear output is laid out ``(py, px, c)``; exp-mode postprocess (the
    norm through expm1, confidence 1 + exp(c))."""
    gh, gw = cfg.grid
    out = linear(p, tokens).reshape(gh, gw, cfg.patch, cfg.patch, 4)
    out = out.permute(0, 2, 1, 3, 4).reshape(gh * cfg.patch,
                                             gw * cfg.patch, 4)
    xyz, conf = out[..., :3], out[..., 3]
    n = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    pts = xyz / torch.clamp(n, min=1e-8) * torch.expm1(n)
    return pts, 1.0 + torch.exp(conf)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def infer_pair(params, img1, img2, cfg: Dust3rConfig = Dust3rConfig()):
    """Two-view inference (f32, TF32 off, under ``torch.inference_mode``).

    Args:
      params: the parameter tree (:attr:`Dust3rNet.params`).
      img1/img2: ``[H, W, 3]`` f32 tensors in [-1, 1] (DUSt3R
        normalization), on the parameters' device.

    Returns dict with ``pts1`` ``[H, W, 3]`` (view-1 geometry in view-1
    frame), ``pts2`` (view-2 geometry in view-1 frame), ``conf1/conf2``.
    """
    with torch.inference_mode(), _no_tf32():
        f1 = encode(params, img1, cfg)
        f2 = encode(params, img2, cfg)
        d1, d2 = decode_pair(params, f1, f2, cfg)
        pts1, conf1 = head(params["head1"], d1, cfg)
        pts2, conf2 = head(params["head2"], d2, cfg)
    return {"pts1": pts1, "conf1": conf1, "pts2": pts2, "conf2": conf2}


class Dust3rNet(ParamTree):
    """The network as a module: its parameter tree's tensors are buffers
    (``.to(device)`` moves them; the weights are frozen), ``forward`` runs
    :func:`infer_pair`."""

    def __init__(self, params, cfg: Dust3rConfig = Dust3rConfig()):
        """``params``: the tree of arrays or tensors, in the port's
        layouts."""
        super().__init__(params)
        self.cfg = cfg

    def forward(self, img1, img2):
        return infer_pair(self.params, img1, img2, self.cfg)


# ---------------------------------------------------------------------------
# torch checkpoint conversion (the JAX package's key mapping; parity with the
# released model waits for its checkpoint)
# ---------------------------------------------------------------------------

def convert_dust3r(path_or_state, cfg: Dust3rConfig = Dust3rConfig()):
    """A :class:`Dust3rNet` (on the CPU, f32) from a checkpoint path or a
    state dict in the upstream key layout (``{"model": ...}`` or bare);
    f16 and bf16 tensors are read as f32."""
    if isinstance(path_or_state, (str, bytes)):
        state = torch.load(path_or_state, map_location="cpu",
                           weights_only=False)
    else:
        state = path_or_state
    if "model" in state:
        state = state["model"]

    def t(k):
        return state[k].detach().float()

    def lin(prefix):
        return {"w": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    def ln(prefix):
        return {"g": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    def attn(prefix, dim):
        # croco's self-attention has a fused qkv
        w, b = t(f"{prefix}.qkv.weight"), t(f"{prefix}.qkv.bias")
        return {"q": {"w": w[:dim], "b": b[:dim]},
                "k": {"w": w[dim:2 * dim], "b": b[dim:2 * dim]},
                "v": {"w": w[2 * dim:], "b": b[2 * dim:]},
                "proj": lin(f"{prefix}.proj")}

    def block(prefix, dim, cross=False):
        p = {"ln1": ln(f"{prefix}.norm1"),
             "attn": attn(f"{prefix}.attn", dim),
             "ln2": ln(f"{prefix}.norm2"),
             "mlp": {"fc1": lin(f"{prefix}.mlp.fc1"),
                     "fc2": lin(f"{prefix}.mlp.fc2")}}
        if cross:
            p["ln_cross"] = ln(f"{prefix}.norm3")
            p["ln_ctx"] = ln(f"{prefix}.norm_y")
            p["cross"] = {k: lin(f"{prefix}.cross_attn.{n}") for k, n in
                          (("q", "projq"), ("k", "projk"), ("v", "projv"),
                           ("proj", "proj"))}
        return p

    params = {
        "patch_embed": {"w": t("patch_embed.proj.weight"),
                        "b": t("patch_embed.proj.bias")},
        "enc_blocks": [block(f"enc_blocks.{i}", cfg.enc_dim)
                       for i in range(cfg.enc_depth)],
        "enc_norm": ln("enc_norm"),
        "decoder_embed": lin("decoder_embed"),
        "dec_blocks": [block(f"dec_blocks.{i}", cfg.dec_dim, cross=True)
                       for i in range(cfg.dec_depth)],
        "dec_blocks2": [block(f"dec_blocks2.{i}", cfg.dec_dim, cross=True)
                        for i in range(cfg.dec_depth)],
        "dec_norm": ln("dec_norm"),
        "head1": lin("downstream_head1.proj"),
        "head2": lin("downstream_head2.proj"),
    }
    return Dust3rNet(params, cfg)


def random_dust3r_state(cfg: Dust3rConfig = Dust3rConfig(), seed: int = 0,
                        dtype=torch.float32):
    """A DUSt3R checkpoint of random weights in the upstream key layout,
    ``{"model": {key: tensor}}`` (the keys :func:`convert_dust3r` reads),
    drawn from a seeded ``torch.Generator`` as the JAX package's
    ``init_dust3r`` draws: Linears uniform in +-1/sqrt(fan_in), LayerNorms
    ones and zeros, the patch kernel 0.02-normal with a zero bias.  The
    released checkpoint is not in the repository."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(prefix, din, dout):
        bound = 1.0 / math.sqrt(din)
        for name, shape in (("weight", (dout, din)), ("bias", (dout,))):
            sd[f"{prefix}.{name}"] = (torch.rand(shape, generator=gen) * 2
                                      - 1).mul_(bound).to(dtype)

    def norm(prefix, d):
        sd[f"{prefix}.weight"] = torch.ones(d, dtype=dtype)
        sd[f"{prefix}.bias"] = torch.zeros(d, dtype=dtype)

    def block(prefix, d, cross=False):
        norm(f"{prefix}.norm1", d)
        lin(f"{prefix}.attn.qkv", d, 3 * d)
        lin(f"{prefix}.attn.proj", d, d)
        norm(f"{prefix}.norm2", d)
        lin(f"{prefix}.mlp.fc1", d, 4 * d)
        lin(f"{prefix}.mlp.fc2", 4 * d, d)
        if cross:
            norm(f"{prefix}.norm3", d)
            norm(f"{prefix}.norm_y", d)
            for n in ("projq", "projk", "projv", "proj"):
                lin(f"{prefix}.cross_attn.{n}", d, d)

    sd["patch_embed.proj.weight"] = (0.02 * torch.randn(
        cfg.enc_dim, 3, cfg.patch, cfg.patch, generator=gen)).to(dtype)
    sd["patch_embed.proj.bias"] = torch.zeros(cfg.enc_dim, dtype=dtype)
    for i in range(cfg.enc_depth):
        block(f"enc_blocks.{i}", cfg.enc_dim)
    norm("enc_norm", cfg.enc_dim)
    lin("decoder_embed", cfg.enc_dim, cfg.dec_dim)
    for i in range(cfg.dec_depth):
        block(f"dec_blocks.{i}", cfg.dec_dim, cross=True)
        block(f"dec_blocks2.{i}", cfg.dec_dim, cross=True)
    norm("dec_norm", cfg.dec_dim)
    for h in (1, 2):
        lin(f"downstream_head{h}.proj", cfg.dec_dim,
            cfg.patch * cfg.patch * 4)
    return {"model": sd}
