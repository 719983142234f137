"""Wrapper of the match-table kernel that the LZ4 and Snappy encoders share.

=================  ============================  ==========================================================
kernel             source                        replaces / plain PyTorch version
=================  ============================  ==========================================================
match table        ``csrc/lz_match_table.cu``    the XLA pre-pass ``tpucomp/codecs/lz77.py::nearest_prev_occurrence``
                                                 (not a ``pallas_call``) / ``codecs/lz77.py::match_table``
=================  ============================  ==========================================================

The codecs call ``match_table`` with their format's limits
(``codecs.lz4.compress``, ``codecs.snappy.compress``), then their encode
kernel.  ``LAUNCHES`` counts its launches.  The table is allocated with
``torch.empty``: the kernel writes every entry.  The kernel's library gives
the grid and the size of its scratch (two index arrays for each CTA the
card holds at once, for rows past 64 KB; none for shorter rows), so the
scratch is bounded by the card, not the batch.  The checks, the launch and
its ``.launch`` span are ``kernels/_build.py``'s.

Spans (``utils/profiling.py``): ``.table`` under the codec's span
(``compress.lz4.table``, ``compress.snappy.table``).  Counters:
``lz.table.positions`` and ``lz.table.large_bucket_positions``, which the
kernel adds to for rows of up to 64 KB (one address, the first's; the
second is the next slot).
"""

from __future__ import annotations

import ctypes

import torch

from tpucomp_torch.kernels import _build
from tpucomp_torch.utils.profiling import span

LAUNCHES = {"table": 0}


def match_table(data: torch.Tensor, lengths: torch.Tensor, stride: int, max_offset: int,
                end_margin: int) -> torch.Tensor:
    """Match-table kernel: data uint8[B, C], lengths int32[B] in [0, C] on one
    CUDA device -> uint16[B, C], equal to ``lz77.match_table`` with the same
    arguments (``stride`` 1, 2 or 4, ``max_offset`` <= 65535, ``end_margin``
    >= 4)."""
    with span(".table"):
        dev = _build.check_cuda("tc_lz_match_table", data, lengths)
        if data.dtype != torch.uint8 or data.dim() != 2:
            raise ValueError("data must be uint8[B, C]")
        if lengths.dtype != torch.int32 or tuple(lengths.shape) != (data.shape[0],):
            raise ValueError(f"lengths must be int32[{data.shape[0]}]")
        if stride not in (1, 2, 4):
            raise ValueError("stride must be 1, 2 or 4")
        if not (1 <= max_offset <= 65535 and end_margin >= 4):
            raise ValueError("the table kernel takes max_offset in [1, 65535] and end_margin >= 4")
        b, c = data.shape
        if c > 1 << 24:
            raise ValueError("the match-table kernel takes rows of at most 16 MB")
        data, lengths = data.contiguous(), lengths.contiguous()
        table = torch.empty(b, c, dtype=torch.uint16, device=dev)  # the kernel writes every entry
        if b == 0 or c == 0:
            return table
        with torch.cuda.device(dev):
            scratch_bytes = ctypes.c_longlong(0)
            grid = _build.load().tc_lz_match_table_grid(b, c, ctypes.byref(scratch_bytes))
        if grid <= 0:
            raise RuntimeError(f"LZ match-table kernel: occupancy query failed with CUDA error {-grid}")
        scratch = torch.empty(scratch_bytes.value, dtype=torch.uint8, device=dev)
        _build.launch(
            "tc_lz_match_table", dev, "lz.table.positions",
            data.data_ptr(), lengths.data_ptr(), table.data_ptr(), scratch.data_ptr(), b, c, stride,
            max_offset, end_margin, grid,
        )
        LAUNCHES["table"] += 1
        return table
