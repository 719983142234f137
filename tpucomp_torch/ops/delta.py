"""Delta stage: adjacent differences and their prefix-sum inverse.

PyTorch counterpart of ``tpucomp.ops.delta``.  Elements are int64 units of
``width`` bytes (see utils/bits.py); all arithmetic wraps in the element
width.  Functions take a batch of buffers ``x[..., E]`` with valid counts
``n[...]``.
"""

from __future__ import annotations

import torch

from tpucomp_torch.utils.bits import unit_mask


def delta_encode(x: torch.Tensor, n: torch.Tensor, width: int):
    """out[i] = x[i+1] - x[i] for i < n-1; x[0] is returned separately (the
    caller stores it in the delta header; 0 when n == 0).

    Returns (deltas[..., E], first[...], out_count = max(n - 1, 0)).
    """
    i = torch.arange(x.shape[-1], device=x.device)
    d = (torch.roll(x, -1, -1) - x) & unit_mask(width)
    d = torch.where(i < n[..., None] - 1, d, 0)
    first = torch.where(n > 0, x[..., 0], 0)
    return d, first, (n - 1).clamp(min=0)


def delta_decode(d: torch.Tensor, first: torch.Tensor, n: torch.Tensor, width: int):
    """Inverse of delta_encode: out[i] = first + sum(d[:i]) for i <= n.

    ``n`` is the number of *input* deltas; returns (out[..., E], n + 1).
    """
    i = torch.arange(d.shape[-1], device=d.device)
    nn = n[..., None]
    masked = torch.where(i < nn, d, 0)
    exc = torch.cumsum(masked, -1) - masked
    out = (exc + first[..., None]) & unit_mask(width)
    return torch.where(i <= nn, out, 0), n + 1
