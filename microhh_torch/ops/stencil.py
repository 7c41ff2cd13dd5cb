"""Shift helpers for horizontally-periodic stencils (``microhh_tpu/ops/stencil.py``).

Arrays are (k, j, i).  Horizontal periodicity is a ``torch.roll``; vertical
shifts are explicit k-slices of the ghost-padded arrays (see grid.py).
"""

import torch

__all__ = ["im", "ip", "jm", "jp", "i2"]


def im(a, n=1):
    """a[..., i-n] with periodic wrap."""
    return torch.roll(a, n, dims=-1)


def ip(a, n=1):
    """a[..., i+n] with periodic wrap."""
    return torch.roll(a, -n, dims=-1)


def jm(a, n=1):
    """a[:, j-n, :] with periodic wrap."""
    return torch.roll(a, n, dims=-2)


def jp(a, n=1):
    """a[:, j+n, :] with periodic wrap."""
    return torch.roll(a, -n, dims=-2)


def i2(a, b):
    """2nd-order midpoint interpolation (reference interp2)."""
    return 0.5 * (a + b)
