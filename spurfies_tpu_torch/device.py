"""Device selection for the port's entry points."""

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    A CUDA device without a card raises: the port never moves work to the
    CPU unless the caller asks for it with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
