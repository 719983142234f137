"""Counts of a batch of LZ4 or Snappy streams, which the emulation checks
hold the kernels' counters to: the codecs' own parse of the streams
(``_delimit``), as ``chip_smoke.py`` reads it on the card."""

import torch

from tpucomp_torch.codecs import lz4 as tl
from tpucomp_torch.codecs import snappy as ts


def stream_counts(codec: str, comp: torch.Tensor, sizes: torch.Tensor, cap: int) -> tuple[int, int]:
    """(elements, sequences) of the well-formed streams ``comp[i, :sizes[i]]``
    that decode into ``cap`` bytes or fewer.  LZ4: both are its sequences,
    the last literals-only one included.  Snappy: its literal and copy
    elements, and the encoder's sequences, a literal run and its match (the
    copies in a row at one distance), the last literals-only one included
    (none for an empty stream)."""
    if codec == "lz4":
        steps = int(tl._delimit(comp, sizes, cap, comp.shape[1] // 3 + 2)[1].sum())
        return steps, steps
    (_, _, _, mlen, off), steps, total, _ = ts._delimit(comp, sizes, cap, comp.shape[1] // 2 + 2)
    cont = torch.zeros_like(mlen, dtype=torch.bool)
    cont[:, 1:] = (mlen[:, :-1] > 0) & (off[:, 1:] == off[:, :-1])
    return int(steps.sum()), int(((mlen > 0) & ~cont).sum() + (total > 0).sum())


LZ4_BATCH = 16  # sequences a batch of the LZ4 decode kernel's walk (kBatch, csrc/lz4_handoff.cuh)


def lz4_handoffs(comp: torch.Tensor, sizes: torch.Tensor, cap: int) -> int:
    """The ring slots the LZ4 decode kernel's walker fills on the
    well-formed streams ``comp[i, :sizes[i]]``: a batch of up to 16
    sequences a slot, the last one marking the row's end, and one slot for
    a row of no sequence."""
    steps = tl._delimit(comp, sizes, cap, comp.shape[1] // 3 + 2)[1]
    return int(torch.clamp((steps + LZ4_BATCH - 1) // LZ4_BATCH, min=1).sum())
