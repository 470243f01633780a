"""Device selection for the port's entry points, and small device constants."""

import functools

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


@functools.lru_cache(maxsize=256)
def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor (a number or a tuple of numbers) on
    ``device``, made once per ``(values, dtype, device)``.

    A host-to-card copy from pageable memory waits for the card, so a
    training step that built its constants with ``torch.tensor(...,
    device=...)`` would stall the host once per constant.  Callers must not
    write to the tensor: it is shared.
    """
    return torch.tensor(values, dtype=dtype, device=torch.device(device))
