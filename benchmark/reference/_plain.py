"""Helpers of the plain references: element units and data placement.

Frozen copies of the port's ``utils/bits.py`` and ``utils/permute.py``
(as of the benchmark's first version), in plain PyTorch.  An element of
width w is held as an int64 "unit": the unsigned value for w <= 4, the
raw two's complement bits for w == 8.
"""

from __future__ import annotations

import torch

SIGNED_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
WIDTH_OF_TYPE = {0: 1, 1: 1, 2: 2, 3: 2, 4: 4, 5: 4, 6: 8, 7: 8}  # hipcompType_t -> bytes
TYPE_BY_NAME = {"CHAR": 0, "UCHAR": 1, "SHORT": 2, "USHORT": 3, "INT": 4, "UINT": 5, "LONGLONG": 6,
                "ULONGLONG": 7}


def round_up_to(x: int, y: int) -> int:
    return (x + y - 1) // y * y


def ru(x, y: int):
    """Round up, for tensors and ints alike."""
    return (x + (y - 1)) // y * y


def unit_mask(width: int) -> int:
    return -1 if width == 8 else (1 << (8 * width)) - 1


def to_signed(x: torch.Tensor, width: int) -> torch.Tensor:
    if width == 8:
        return x
    top = 1 << (8 * width - 1)
    return ((x & unit_mask(width)) ^ top) - top


def shl(x: torch.Tensor, s) -> torch.Tensor:
    """64-bit left shift; a shift outside [0, 64) gives 0."""
    s = torch.as_tensor(s, device=x.device)
    ok = (s >= 0) & (s < 64)
    return torch.where(ok, x << s.clamp(0, 63), torch.zeros_like(x))


def shr(x: torch.Tensor, s) -> torch.Tensor:
    """64-bit logical right shift; a shift outside [0, 64) gives 0."""
    s = torch.as_tensor(s, device=x.device)
    sc = s.clamp(1, 63)
    logical = (x >> sc) & ((torch.ones_like(sc) << (64 - sc)) - 1)
    out = torch.where(s == 0, x, logical)
    return torch.where((s >= 0) & (s < 64), out, torch.zeros_like(x))


def bit_width(r: torch.Tensor) -> torch.Tensor:
    """Significant bits of int64 ``r`` read as unsigned 64-bit."""
    neg = r < 0
    r = torch.where(neg, torch.zeros_like(r), r)
    bw = torch.zeros_like(r)
    shift = 32
    while shift:
        high = r >> shift
        has = high != 0
        bw = bw + torch.where(has, shift, 0)
        r = torch.where(has, high, r)
        shift //= 2
    bw = bw + (r != 0).to(bw.dtype)
    return torch.where(neg, torch.full_like(bw, 64), bw)


def _view(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b = b.contiguous()
    if b.storage_offset() % dtype.itemsize:
        b = b.clone()
    return b.view(dtype)


def bytes_to_units_le(b: torch.Tensor, width: int) -> torch.Tensor:
    if width == 1:
        return b.to(torch.int64)
    return _view(b, SIGNED_OF_WIDTH[width]).to(torch.int64) & unit_mask(width)


def units_to_bytes_le(u: torch.Tensor, width: int) -> torch.Tensor:
    if width == 1:
        return (u & 0xFF).to(torch.uint8)
    s = to_signed(u, width).to(SIGNED_OF_WIDTH[width]).contiguous()
    return s.view(torch.uint8)


def place(out: torch.Tensor, targets: torch.Tensor, values: torch.Tensor, valid: torch.Tensor) -> None:
    """``out.view(-1)[targets[m]] = values[m]`` for valid m; ``out`` holds
    one spare element at its end, where invalid entries land."""
    flat = out.view(-1)
    dump = flat.numel() - 1
    idx = torch.where(valid, targets, torch.full_like(targets, dump))
    flat.index_put_((idx.reshape(-1),), values.reshape(-1).to(flat.dtype))


def ffill(vals: torch.Tensor, is_src: torch.Tensor) -> torch.Tensor:
    """``out[i] = vals[j]`` for the largest ``j <= i`` with ``is_src[j]``."""
    i = torch.arange(is_src.shape[-1], device=is_src.device).expand_as(is_src)
    return vals.gather(-1, torch.where(is_src, i, -1).cummax(-1).values.clamp(min=0))


def fill_from_markers(starts: torch.Tensor, valid: torch.Tensor, vals_list, out_size: int):
    """For each output position t, the values of the last valid marker m
    with ``starts[m] <= t`` (0 before the first marker)."""
    b, m = starts.shape
    keep = valid & (starts >= 0) & (starts < out_size)
    idx = torch.where(keep, starts, out_size).long()
    marker = torch.full((b, out_size + 1), -1, dtype=torch.int64, device=starts.device)
    marker.scatter_(1, idx, torch.arange(m, device=starts.device).expand(b, m))
    marker = marker[:, :out_size]
    sid = ffill(marker, marker >= 0)
    return [torch.where(sid >= 0, v.gather(1, sid.clamp(min=0)), 0).to(v.dtype) for v in vals_list]


def in_blocks(fn, data: torch.Tensor, lengths: torch.Tensor, block_rows: int):
    """``fn(data, lengths)`` over blocks of ``block_rows`` rows, results
    concatenated: the reference fits the card beside what it judges."""
    outs = [fn(data[i : i + block_rows], lengths[i : i + block_rows]) for i in range(0, data.shape[0], block_rows)]
    return tuple(torch.cat(parts) for parts in zip(*outs))
