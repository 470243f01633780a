"""LPIPS perceptual metric (VGG16 backbone + linear heads), on the device
(port of ``spurfies_tpu/eval/lpips_jax.py``).

Behavioral spec from the reference's vendored ``lpipsPyTorch/`` (LPIPS
v0.1, VGG16 features from relu1_2/relu2_2/relu3_3/relu4_3/relu5_3,
per-channel unit-normalize, learned 1x1 linear heads, spatial mean, summed
across stages; inputs scaled by ImageNet-style shift/scale constants).

The weights are not in the repository and cannot be downloaded: the
converters take user-supplied torch state dicts (torchvision ``vgg16`` and
the richzhang ``vgg.pth`` linear weights), and :func:`make_lpips_fn`
returns None without them.  The convolutions are ``F.conv2d`` (the JAX
package leaves them to ``lax.conv`` as well, not to a kernel of its own).
"""

import os

import torch
import torch.nn.functional as F

from spurfies_tpu_torch.device import resolve_device

# torchvision VGG16 ``features`` indices of the convolutions, the max pools
# and the ReLUs that end each LPIPS stage
CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_POOLS = (4, 9, 16, 23)
_STAGE_ENDS = (3, 8, 15, 22, 29)
CHANNELS = (64, 128, 256, 512, 512)

# LPIPS input normalization (lpips v0.1 scaling layer constants)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _state(path_or_state):
    if isinstance(path_or_state, (str, bytes, os.PathLike)):
        path_or_state = torch.load(path_or_state, map_location="cpu",
                                   weights_only=False)
    if "state_dict" in path_or_state:
        path_or_state = path_or_state["state_dict"]
    return path_or_state


def convert_vgg16_features(path_or_state, device="cuda"):
    """torchvision VGG16 state dict (or its path) -> ``{str(i): (w [O, I,
    3, 3], b [O])}`` f32 on ``device``, for each convolution index i."""
    state = _state(path_or_state)
    dev = resolve_device(device)
    return {str(i): (state[f"features.{i}.weight"].detach().float().to(dev),
                     state[f"features.{i}.bias"].detach().float().to(dev))
            for i in CONV_IDX}


def convert_lpips_linear(path_or_state, device="cuda"):
    """richzhang lpips ``vgg.pth`` (or its path) -> five ``[C]`` f32
    weights on ``device``, one per stage."""
    state = _state(path_or_state)
    dev = resolve_device(device)
    return [state[f"lin{i}.model.1.weight"].detach().float().reshape(-1)
            .to(dev) for i in range(5)]


def vgg_stage_features(convs, x):
    """x ``[B, 3, H, W]`` in [-1, 1] -> the five stage feature maps."""
    dev = x.device
    x = (x - torch.tensor(_SHIFT, device=dev)[:, None, None]) \
        / torch.tensor(_SCALE, device=dev)[:, None, None]
    feats = []
    for i in range(30):
        if str(i) in convs:
            w, b = convs[str(i)]
            x = F.conv2d(x, w, b, padding=1)
        elif i in _POOLS:
            x = F.max_pool2d(x, 2, 2)
        else:
            x = F.relu(x)
        if i in _STAGE_ENDS:
            feats.append(x)
    return feats


def lpips(convs, lins, img1, img2):
    """img: ``[H, W, 3]`` in [0, 1] (numpy or tensor).  Returns the scalar
    LPIPS distance, a 0-dim f32 tensor on the weights' device."""
    dev = lins[0].device

    def prep(im):
        t = torch.as_tensor(im, device=dev).float()
        return (t.permute(2, 0, 1)[None] * 2.0 - 1.0).contiguous()

    with torch.no_grad():
        f1 = vgg_stage_features(convs, prep(img1))
        f2 = vgg_stage_features(convs, prep(img2))
        total = torch.zeros((), device=dev)
        for a, b, w in zip(f1, f2, lins):
            na = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            nb = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2
            total = total + torch.mean(torch.sum(d * w[None, :, None, None],
                                                 dim=1))
    return total


def lpips_available(vgg_path="ckpt/vgg16.pth",
                    lin_path="ckpt/lpips_vgg.pth") -> bool:
    return os.path.exists(vgg_path) and os.path.exists(lin_path)


def make_lpips_fn(vgg_path="ckpt/vgg16.pth", lin_path="ckpt/lpips_vgg.pth",
                  device="cuda"):
    """``lpips(img1, img2) -> float`` on ``device``, or None when the
    weights are absent."""
    if not lpips_available(vgg_path, lin_path):
        return None
    convs = convert_vgg16_features(vgg_path, device)
    lins = convert_lpips_linear(lin_path, device)
    return lambda a, b: float(lpips(convs, lins, a, b))
