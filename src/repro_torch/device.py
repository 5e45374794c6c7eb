"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the GPU: raise when there is none rather than carry on
    silently on the CPU.  An explicit device (``"cpu"`` in the tests) is
    taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run the port's "
                "plain PyTorch path on the host")
        return torch.device("cuda")
    return torch.device(device)


def chunks(n: int, size: int):
    """``(start, stop)`` row ranges of at most ``size`` rows covering ``n``."""
    for i in range(0, n, size):
        yield i, min(i + size, n)
