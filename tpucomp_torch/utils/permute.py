"""Data-movement primitives of the plain cascaded path.

The JAX package expresses every data-dependent permutation as a sort,
because gathers and scatters are slow on a TPU.  On torch they are direct:
``place`` is one ``index_put_`` and ``expand_runs`` one ``searchsorted``
and a gather.
"""

from __future__ import annotations

import torch


def place(out: torch.Tensor, targets: torch.Tensor, values: torch.Tensor, valid: torch.Tensor) -> None:
    """In place: ``out.view(-1)[targets[m]] = values[m]`` for valid m.

    ``out`` must be contiguous and hold one spare element at its end: invalid
    entries are written there, so the caller allocates it and slices it off.
    Valid targets must be distinct.
    """
    flat = out.view(-1)
    dump = flat.numel() - 1
    idx = torch.where(valid, targets, torch.full_like(targets, dump))
    flat.index_put_((idx.reshape(-1),), values.reshape(-1).to(flat.dtype))


def expand_runs(vals: torch.Tensor, ends: torch.Tensor, out_size: int) -> torch.Tensor:
    """Run expansion over the last axis: ``out[j] = vals[r]`` for the first
    run r whose inclusive end ``ends[r]`` (a cumsum of run lengths) is past
    j.  Positions at or past the last end read the last run's value; the
    caller masks them."""
    j = torch.arange(out_size, device=vals.device).expand(*ends.shape[:-1], out_size)
    r = torch.searchsorted(ends.contiguous(), j.contiguous(), right=True)
    return torch.gather(vals, -1, r.clamp(max=vals.shape[-1] - 1))
