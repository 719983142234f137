"""Data-movement primitives of the plain codec paths.

The JAX package expresses every data-dependent permutation as a sort or an
associative scan, because gathers and scatters are slow on a TPU.  On torch
they are direct: ``place`` is one ``index_put_``, ``expand_runs`` one
``searchsorted`` and a gather, and a forward fill a ``cummax`` of marked
positions and a gather.  All work over the last axis of a batch.
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


def ffill(vals: torch.Tensor, is_src: torch.Tensor) -> torch.Tensor:
    """Forward fill: ``out[i] = vals[j]`` for the largest ``j <= i`` with
    ``is_src[j]``; positions before the first source read ``vals[0]``, as
    the JAX package's associative scan gives them."""
    i = torch.arange(is_src.shape[-1], device=is_src.device).expand_as(is_src)
    return vals.gather(-1, torch.where(is_src, i, -1).cummax(-1).values.clamp(min=0))


def fill_from_markers(starts: torch.Tensor, valid: torch.Tensor, vals_list, out_size: int):
    """Per-position piecewise-constant parameters: for each output position
    t, the values of the last valid marker m with ``starts[m] <= t``;
    positions before the first marker read 0.

    ``starts``, ``valid`` and each of ``vals_list`` are [B, M]; valid starts
    must be distinct, and those outside [0, out_size) are dropped.  Returns
    one [B, out_size] tensor per value.
    """
    b, m = starts.shape
    keep = valid & (starts >= 0) & (starts < out_size)
    idx = torch.where(keep, starts, out_size).long()
    marker = torch.full((b, out_size + 1), -1, dtype=torch.int64, device=starts.device)
    marker.scatter_(1, idx, torch.arange(m, device=starts.device).expand(b, m))
    marker = marker[:, :out_size]
    sid = ffill(marker, marker >= 0)  # -1 before the first marker
    return [torch.where(sid >= 0, v.gather(1, sid.clamp(min=0)), 0).to(v.dtype) for v in vals_list]
