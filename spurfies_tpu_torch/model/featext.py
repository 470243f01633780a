"""The Vis-MVSNet feature extractor, a frozen UNet (port of
``spurfies_tpu/model/featext.py``), on NCHW tensors.

Reference ``spurfies/feat_utils.py:179-374``:
  * FeatExt = Conv(3->16, k5, s2, p2, no bias) + BN + ReLU, then
    UNet(16, enc=2, dec=1, filters=[32, 64, 128]):
      - 3 encoder stages of 2 BasicBlocks each (strides 1, 2, 2),
      - 2 decoder stages: ConvTranspose(k3, s2, p1, op1) -> concat skip ->
        Conv(2f->f, k3) -> 1 BasicBlock,
    and three 3x3 heads mapping the (128, 64, 32)-channel maps to 32
    channels.
  * BasicBlock = conv3x3-BN-ReLU-conv3x3-BN (+ 1x1-BN downsample) + ReLU.
  * Only eval mode is used (the weights are frozen), so each BatchNorm is
    folded into a per-channel scale and shift when the weights are
    converted (``convert.torch_ckpt.convert_vismvsnet``).

The parameter tree mirrors the JAX package's, in PyTorch's layouts: conv
kernels ``[out, in, kh, kw]``, the transposed convolutions ``[in, out, kh,
kw]`` (``F.conv_transpose2d``'s), each BN ``{"scale", "shift"}``.  The
convolutions are cuDNN's (``F.conv2d`` / ``F.conv_transpose2d``): the JAX
package runs them as XLA convolutions, not in Pallas.  Precision: f32 with
TF32 off (``torch.backends.cudnn.flags(allow_tf32=False)`` around the
forward), so the card's features are the CPU's up to the sum order; the
extractor runs once per scene (3 images), where the f32 cost is small.
"""

import torch
import torch.nn.functional as F

from spurfies_tpu_torch.model.networks import ParamTree


def _conv(x, w, stride=1):
    """torch-style symmetric padding (k - 1) // 2."""
    return F.conv2d(x, w, stride=stride, padding=(w.shape[-1] - 1) // 2)


def _bn(x, p):
    return x * p["scale"][:, None, None] + p["shift"][:, None, None]


def basic_block(x, p):
    out = torch.relu(_bn(_conv(x, p["conv1"]["w"], p["stride"]), p["bn1"]))
    out = _bn(_conv(out, p["conv2"]["w"]), p["bn2"])
    if "downsample" in p:
        res = _bn(_conv(x, p["downsample"]["w"], p["stride"]),
                  p["downsample_bn"])
    else:
        res = x
    return torch.relu(out + res)


def featext_apply(params, x, return_stages: bool = False):
    """x ``[N, 3, H, W]`` ImageNet-normalized -> the three 32-channel
    feature maps at 1/8, 1/4 and 1/2 of the input resolution (reference
    forward, feat_utils.py:370-374).

    return_stages: also return the named intermediate activations (init,
    enc{i}, dec{i}, f{1,2,3}), the JAX function's stages, for a
    layer-by-layer comparison."""
    stages = {}
    out = torch.relu(_bn(_conv(x, params["init_conv"]["w"], 2),
                         params["init_bn"]))
    stages["init"] = out
    enc_out = []
    for i, stage in enumerate(params["enc"]):
        for block in stage:
            out = basic_block(out, block)
        enc_out.append(out)
        stages[f"enc{i}"] = out
    dec_out = [out]
    x_ = out
    for i, d in enumerate(params["dec"]):
        x_ = F.conv_transpose2d(x_, d["deconv"]["w"], stride=2, padding=1,
                                output_padding=1)
        x_ = _conv(torch.cat([x_, enc_out[-2 - i]], 1), d["post"]["w"])
        for block in d["res"]:
            x_ = basic_block(x_, block)
        dec_out.append(x_)
        stages[f"dec{i}"] = x_
    f1 = _conv(dec_out[0], params["head1"]["w"])
    f2 = _conv(dec_out[1], params["head2"]["w"])
    f3 = _conv(dec_out[2], params["head3"]["w"])
    stages.update(f1=f1, f2=f2, f3=f3)
    if return_stages:
        return (f1, f2, f3), stages
    return f1, f2, f3


class FeatExt(ParamTree):
    """The frozen extractor as a module: its parameter tree's tensors are
    buffers (``.to(device)`` moves them); ``forward`` runs
    :func:`featext_apply` in f32 with TF32 off."""

    def __init__(self, params):
        """``params``: the tree of arrays or tensors (a block's
        ``"stride"`` an int or a 0-d array)."""
        super().__init__(params, ints=("stride",))

    def forward(self, x, return_stages: bool = False):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return featext_apply(self.params, x, return_stages)
