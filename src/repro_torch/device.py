"""Device resolution shared by every entry point of the port, and the
row sum whose order does not depend on the batch shape."""

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


#: rows from which a CUDA reduction over a long last dim gives every row
#: the same lanes
_MIN_ROWS = 16


def row_sum(t: torch.Tensor) -> torch.Tensor:
    """``t.sum(-1)`` in an order that depends on the row alone, not on how
    many rows the tensor holds.

    A CUDA reduction over a last dim longer than 32 spreads each row over
    more lanes when fewer than 16 rows are reduced, so one query alone
    could sum its terms in another order than the same query in a batch
    (the card showed it: an exact L2 over 10 fetched rows at Q = 1 against
    the same rows in a batch).  From 16 rows on, every row is summed by
    one warp whatever the count, so fewer rows are padded with zero rows
    to 16 and cut off again.  The CPU sums each row alike at any count;
    the padding changes nothing there."""
    rows = t.reshape(-1, t.shape[-1])
    n = rows.shape[0]
    if n < _MIN_ROWS:
        rows = torch.cat([rows, rows.new_zeros(_MIN_ROWS - n,
                                               rows.shape[1])])
    return rows.sum(-1)[:n].reshape(t.shape[:-1])
