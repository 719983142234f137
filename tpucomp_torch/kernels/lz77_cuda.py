"""Wrapper of the match-table kernel that the LZ4 and Snappy encoders share.

=================  ============================  ==========================================================
kernel             source                        replaces / plain PyTorch version
=================  ============================  ==========================================================
match table        ``csrc/lz_match_table.cu``    the XLA pre-pass ``tpucomp/codecs/lz77.py::nearest_prev_occurrence``
                                                 (not a ``pallas_call``) / ``codecs/lz77.py::match_table``
=================  ============================  ==========================================================

``match_table`` takes CUDA tensors only and launches on PyTorch's current
stream; it raises on anything the kernel does not take.  The codecs call
it with their format's limits (``codecs.lz4.compress``,
``codecs.snappy.compress``), then their encode kernel.  ``LAUNCHES``
counts its launches.  The table is allocated with ``torch.empty``: the
kernel writes every entry.  The kernel's library gives the grid and the
size of its scratch (two index arrays for each CTA the card holds at
once), so the scratch is bounded by the card, not the batch.
"""

from __future__ import annotations

import ctypes

import torch

from tpucomp_torch.kernels import _build

LAUNCHES = {"table": 0}


def match_table(data: torch.Tensor, lengths: torch.Tensor, stride: int, max_offset: int,
                end_margin: int) -> torch.Tensor:
    """Match-table kernel: data uint8[B, C], lengths int32[B] in [0, C] on one
    CUDA device -> uint16[B, C], equal to ``lz77.match_table`` with the same
    arguments (``stride`` 1, 2 or 4, ``max_offset`` <= 65535, ``end_margin``
    >= 4)."""
    for t in (data, lengths):
        if not t.is_cuda:
            raise ValueError(f"the CUDA LZ kernels take CUDA tensors, got one on {t.device}")
    if data.device != lengths.device:
        raise ValueError("all tensors must lie on one device")
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
    table = torch.empty(b, c, dtype=torch.uint16, device=data.device)  # the kernel writes every entry
    if b == 0 or c == 0:
        return table
    lib = _build.load()
    with torch.cuda.device(data.device):
        scratch_bytes = ctypes.c_longlong(0)
        grid = lib.tc_lz_match_table_grid(b, c, ctypes.byref(scratch_bytes))
        if grid <= 0:
            raise RuntimeError(f"LZ match-table kernel: occupancy query failed with CUDA error {-grid}")
        scratch = torch.empty(scratch_bytes.value, dtype=torch.uint8, device=data.device)
        err = lib.tc_lz_match_table(
            data.data_ptr(), lengths.data_ptr(), table.data_ptr(), scratch.data_ptr(), b, c, stride,
            max_offset, end_margin, grid, torch.cuda.current_stream(data.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"LZ match-table kernel launch failed with CUDA error {err}")
    LAUNCHES["table"] += 1
    return table
