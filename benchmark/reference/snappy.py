"""Plain reference of the Snappy compressor: the bytes tpucomp emits.

A frozen copy, in plain PyTorch, of the port's plain Snappy encoder
(``codecs/snappy.py`` ``_compress_plain`` over ``codecs/lz77.py``), which
the port's tests hold to the JAX package's Pallas kernel and to a
sequential oracle.  The parse: per partition, the pure greedy parse over
the exact nearest previous occurrence of every 4-byte window (one sort per
row, no hash collisions), matches at most ``MAX_OFFSET`` back and starting
at most 4 bytes before the end, extended exactly and without bound (no end
rules).  The stream: a varint of the partition's length, then literal
elements and copy elements of at most 64 bytes (``MAX_COPY``), with 1- or
2-byte offsets.  The sort, the match lengths and the greedy parse are the
LZ4 reference's, which copies the same port functions.

``max_offset`` below 32768 is the control: still valid, lossless Snappy,
but a shorter match window than the configuration states, so not
tpucomp's bytes.
"""

from __future__ import annotations

import torch

from benchmark.reference import _plain
from benchmark.reference import lz4 as _lz

MIN_MATCH = 4
MAX_OFFSET = 32768  # the window (hipCOMP src/snappy/config.h MAX_COPY_DISTANCE)
MAX_COPY = 64  # the longest copy element (MAX_COPY_LENGTH)
INF = _lz.INF
CONTROL = {"max_offset": 4095}  # the control: a 4 KB match window in place of 32 KB
ARTIFACT_FORMAT = 1  # the format byte of a manager's artifact


def artifact_header(opts: dict) -> bytes:
    """The format's own header in a manager's artifact: one reserved byte."""
    return b"\x00"


def max_compressed_size(n: int) -> int:
    """The worst-case stream of an n-byte partition: 32 + n + n / 6."""
    return 32 + n + n // 6


def _varint_len(n: torch.Tensor) -> torch.Tensor:
    return 1 + (n >= 1 << 7).long() + (n >= 1 << 14).long() + (n >= 1 << 21).long()


def _copy_pieces(ml: torch.Tensor, off: torch.Tensor):
    """A match split into copy elements: k64 copies of 64 bytes (2-byte
    offset), a copy of 60 where 65-67 bytes remain, then a last copy with a
    1-byte offset field (4-11 bytes, offset < 2048) or a 2-byte one.
    Returns (k64, has60, final_len, final_is_copy1, bytes)."""
    k64 = torch.where(ml >= MAX_COPY + 4, torch.div(ml - 4, MAX_COPY, rounding_mode="floor"), 0)
    rem = ml - MAX_COPY * k64
    has60 = (rem > MAX_COPY).long()
    final = rem - 60 * has60
    is_c1 = (final <= 11) & (off < 2048)
    total = 3 * k64 + 3 * has60 + torch.where(is_c1, 2, 3)
    return k64, has60, final, is_c1, torch.where(ml > 0, total, 0)


def _lit_hdr(ll: torch.Tensor) -> torch.Tensor:
    """Literal header bytes of a run of ll >= 0 bytes (0 for none)."""
    v = ll - 1
    extra = (v >= 60).long() + (v >= 1 << 8).long() + (v >= 1 << 16).long()
    return torch.where(ll > 0, 1 + extra, 0)


def _emit(data, lit_start, lit_len, match_len, offset, num_seqs, n, out_max: int):
    """Every output byte finds its sequence and its place in it (literal
    header, literal, copy element); the varint of n comes first."""
    b, s_max = lit_start.shape
    dev = data.device
    si = torch.arange(s_max, device=dev)[None, :]
    valid = si < num_seqs[:, None]
    lhdr = _lit_hdr(lit_len)
    k64, has60, final, is_c1, copy_bytes = _copy_pieces(match_len, offset)
    seq_bytes = torch.where(valid, lhdr + lit_len + copy_bytes, 0)
    vlen = _varint_len(n)
    inc = seq_bytes.cumsum(-1)
    out_start = vlen[:, None] + inc - seq_bytes
    total = vlen + inc[:, -1]
    sid = _plain.fill_from_markers(out_start, valid & (seq_bytes > 0), [si.expand(b, s_max)], out_max)[0]

    def at(x):
        return x.gather(1, sid)

    p_ll, p_lh, p_off, p_k64, p_has60, p_final = at(lit_len), at(lhdr), at(offset), at(k64), at(has60), at(final)
    t = torch.arange(out_max, device=dev)[None, :]
    u = t - at(out_start)
    # literal header: the tag, then the LE bytes of ll - 1
    v = p_ll - 1
    lit_tag = torch.where(p_lh == 1, v << 2, (58 + p_lh) << 2)
    lit_hdr_byte = torch.where(u == 0, lit_tag, (v >> (8 * (u - 1).clamp(min=0))) & 0xFF)
    lit_byte = data.gather(1, (at(lit_start) + u - p_lh).clamp(0, data.shape[1] - 1)).to(torch.int64)
    # copy elements
    w = u - p_lh - p_ll
    off_lo, off_hi = p_off & 0xFF, p_off >> 8
    r3 = w % 3
    in64 = w < 3 * p_k64
    b64 = torch.where(r3 == 0, (63 << 2) | 2, torch.where(r3 == 1, off_lo, off_hi))
    w60 = w - 3 * p_k64
    b60 = torch.where(w60 == 0, (59 << 2) | 2, torch.where(w60 == 1, off_lo, off_hi))
    wf = w60 - 3 * p_has60
    bc1 = torch.where(wf == 0, 1 | ((p_final - 4) << 2) | (off_hi << 5), off_lo)
    bc2 = torch.where(wf == 0, ((p_final - 1) << 2) | 2, torch.where(wf == 1, off_lo, off_hi))
    copy_byte = torch.where(in64, b64, torch.where(w60 < 3 * p_has60, b60, torch.where(at(is_c1), bc1, bc2)))
    val = torch.where(u < p_lh, lit_hdr_byte, torch.where(u < p_lh + p_ll, lit_byte, copy_byte))
    # the varint header
    k = t.clamp(max=3)
    part = (n[:, None] >> (7 * k)) & 0x7F
    vb = torch.where(k < vlen[:, None] - 1, part | 0x80, part)
    val = torch.where(t < vlen[:, None], vb, val)
    return torch.where(t < total[:, None], val, 0).to(torch.uint8), total


def _compress_block(data: torch.Tensor, lengths: torch.Tensor, max_offset: int):
    b, c = data.shape
    n = lengths.to(torch.int64).clamp(0, c)
    j = _lz._nearest_prev_occurrence(data, n, 1)
    i = _lz._iota(c, data.device)
    dist = i - j
    cand = (j >= 0) & (dist <= max_offset) & (i[None, :] <= n[:, None] - MIN_MATCH)
    nmp = _lz._rev_cummin(torch.where(cand, i.to(torch.int32), INF).to(torch.int32))
    del cand
    mlen = _lz._match_lengths(data, n, j, max_offset)
    del j
    m_clamped = torch.minimum(mlen, (n[:, None] - i[None, :]).clamp(min=0))
    del mlen
    seqs = _lz._greedy_parse(nmp, m_clamped, dist, n, c // MIN_MATCH + 2)
    del nmp, dist, m_clamped
    return _emit(data, *seqs, n, max_compressed_size(c))


def compress(data: torch.Tensor, lengths: torch.Tensor, opts: dict, block_rows: int = 1024,
             max_offset: int = MAX_OFFSET):
    """(streams uint8[B, max_compressed_size(C)], sizes int32[B]) of
    uint8[B, C] partitions with valid ``lengths``; ``opts`` is reserved.
    Blocks of 1024 rows of 64 KB: the emission holds some two dozen int64
    arrays of a block's output at once, 15 GB at that size."""
    def block(d, n):
        out, total = _compress_block(d, n, max_offset)
        return out, total.to(torch.int32)

    return _plain.in_blocks(block, data, lengths, block_rows)
