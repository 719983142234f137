"""Run-length-encode stage.

PyTorch counterpart of ``tpucomp.ops.rle`` with the fused cascaded
format's uint16 run counts.  Values are the element of each run, counts
the run lengths; entries past ``num_runs`` are zero.  Functions take a batch
of buffers ``x[..., E]`` with valid counts ``n[...]``.
"""

from __future__ import annotations

import torch

from tpucomp_torch.utils import permute

RUN_MASK = 0xFFFF  # counts are uint16 (chunks hold < 65536 elements)


def rle_encode(x: torch.Tensor, n: torch.Tensor):
    """Encode the valid prefix of ``x`` into runs.

    Returns (vals[..., E] like x, counts[..., E] int64 holding uint16 values,
    num_runs[...]).
    """
    e = x.shape[-1]
    i = torch.arange(e, device=x.device)
    nn = n[..., None]
    is_end = (i == nn - 1) | ((i < nn - 1) & (x != torch.roll(x, -1, -1)))
    num_runs = is_end.sum(-1)
    # compact run ends to the front; non-ends go to a spare column
    rank = torch.where(is_end, torch.cumsum(is_end, -1) - 1, e)
    spare = torch.zeros(*x.shape[:-1], e + 1, dtype=x.dtype, device=x.device)
    vals = spare.clone().scatter_(-1, rank, x)[..., :e]
    ends = spare.scatter_(-1, rank, (i + 1).expand_as(x).to(x.dtype))[..., :e]
    counts = ends - torch.nn.functional.pad(ends[..., :-1], (1, 0))
    run_valid = i < num_runs[..., None]
    vals = torch.where(run_valid, vals, 0)
    counts = torch.where(run_valid, counts & RUN_MASK, 0)
    return vals, counts, num_runs


def rle_decode(vals: torch.Tensor, counts: torch.Tensor, num_runs: torch.Tensor,
               out_elements: int | None = None):
    """Expand runs back into elements.

    Returns (x[..., out_elements], total).  ``total`` is the sum of the first
    ``num_runs`` counts and is NOT clipped to ``out_elements``: the
    cascaded decoder's status checks read it.
    """
    e = vals.shape[-1] if out_elements is None else out_elements
    i = torch.arange(vals.shape[-1], device=vals.device)
    c = torch.where(i < num_runs[..., None], counts, 0)
    inc = torch.cumsum(c, -1)
    total = inc[..., -1]
    x = permute.expand_runs(vals, inc, e)
    j = torch.arange(e, device=vals.device)
    return torch.where(j < total[..., None], x, 0), total
