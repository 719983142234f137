"""Batched Snappy codec (counterpart of ``tpucomp.codecs.snappy``).

Streams are raw Snappy: a varint of the uncompressed length, then tagged
elements: literals (tag kind 0; lengths past 60 take 1-4 extra LE length
bytes) and copies with 1-, 2- or 4-byte offsets.  The encoder keeps the
reference's limits: copy elements of at most 64 bytes, offsets of at most
32768.

compress: the pure greedy parse over the exact nearest previous
occurrence of every position, in the 32768-byte window, with exact,
unbounded match extension.  It emits the same bytes as the JAX package's
Pallas kernel (``tpucomp.kernels.snappy_pallas.compress``) and the
sequential oracle, not those of its XLA path, which clamps parses to 4 KB
blocks.  An empty chunk compresses to one byte, ``varint(0)``.

  - a CUDA batch runs the match-table kernel (window 32768, the last
    candidate at ``n - 4``) and the encode kernel
    (``kernels/snappy_cuda.py``), which find their candidates on the card;
  - a CPU batch runs the plain version: the candidate tables
    (``lz77.candidate_tables``, same limits), exact match lengths
    (``lz77.match_lengths``), ``lz77.greedy_parse`` (Snappy has no end
    rules) and position-driven emission (``_emit``).

decompress: returns what the JAX package's XLA path returns, data,
lengths and statuses, including on corrupt input: a CUDA batch runs the
decode kernel, a CPU batch the plain version (``_delimit``, one element
per step for all rows, then ``lz77.materialize``).  The XLA path's int32
arithmetic is mirrored, wraps included (``_i32``).
"""

from __future__ import annotations

import torch

from tpucomp_torch.codecs import lz77
from tpucomp_torch.core.options import SnappyOpts
from tpucomp_torch.core.sizing import snappy_max_compressed_chunk_size
from tpucomp_torch.core.types import Status
from tpucomp_torch.utils import permute

MAX_OFFSET = 32768  # the encoder's window (reference src/snappy/config.h:91)
MIN_MATCH = 4


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32's range, as the JAX package's int32
    arithmetic wraps them."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _varint_len(n: torch.Tensor) -> torch.Tensor:
    return 1 + (n >= 1 << 7).long() + (n >= 1 << 14).long() + (n >= 1 << 21).long()


# ---------------------------------------------------------------------------
# compression


def _copy_pieces(ml: torch.Tensor, off: torch.Tensor):
    """Closed-form split of a match into copy elements: k64 copy2(64), a
    copy2(60) when the remainder is 65-67, then a final copy1 (length <=
    11, offset < 2048) or copy2.  Returns (k64, has60, final_len,
    final_is_copy1, bytes)."""
    k64 = torch.where(ml >= 68, torch.div(ml - 4, 64, rounding_mode="floor"), 0)
    rem = ml - 64 * k64
    has60 = (rem > 64).long()
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
    """Position-driven emission: every output byte finds its sequence and
    its place in it (literal header, literal, copy element) from the
    sequences' output offsets; the varint of n comes first."""
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
    sid = permute.fill_from_markers(out_start, valid & (seq_bytes > 0), [si.expand(b, s_max)], out_max)[0]

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


def _compress_plain(data: torch.Tensor, lengths: torch.Tensor):
    """Plain PyTorch version of the encode kernel: (comp uint8[B,
    SNAPPYMAX], comp_sizes int32[B]) for lengths in [0, C]."""
    b, c = data.shape
    n = lengths.to(torch.int64)
    j = lz77.nearest_prev_occurrence(data, n)
    nmp, dist = lz77.candidate_tables(data, n, j=j, max_offset=MAX_OFFSET, end_margin=MIN_MATCH)
    mlen = lz77.match_lengths(data, n, j, max_offset=MAX_OFFSET)[0]
    del j
    i = torch.arange(c, device=data.device)[None, :]
    m_clamped = torch.minimum(mlen, (n[:, None] - i).clamp(min=0))
    del mlen
    seqs = lz77.greedy_parse(nmp, m_clamped, dist.to(torch.int64), n, c // MIN_MATCH + 2)
    del nmp, dist, m_clamped
    out, total = _emit(data, *seqs, n, snappy_max_compressed_chunk_size(c))
    return out, total.to(torch.int32)


# ---------------------------------------------------------------------------
# decompression


def _read_varint(comp: torch.Tensor):
    """(vlen, n_out) int64[B] of the varint at the start of each row, as
    the JAX package reads it: at most 4 bytes, the 4th taken as its low 7
    bits whatever its continuation bit; rows shorter than 4 bytes repeat
    their last byte."""
    c = comp.shape[1]
    b0, b1, b2, b3 = (comp[:, min(k, c - 1)].to(torch.int64) for k in range(4))
    vlen = torch.where(b0 < 128, 1, torch.where(b1 < 128, 2, torch.where(b2 < 128, 3, 4)))
    n = b0 & 0x7F
    n = torch.where(vlen >= 2, n | ((b1 & 0x7F) << 7), n)
    n = torch.where(vlen >= 3, n | ((b2 & 0x7F) << 14), n)
    n = torch.where(vlen >= 4, n | ((b3 & 0x7F) << 21), n)
    return vlen, n


def _element_table(comp: torch.Tensor) -> torch.Tensor:
    """int32[B, CMAX, 4]: for an element whose tag is at each position,
    (advance, output bytes, copy offset or 0, literal source - position
    or -1 for a copy), in the JAX package's int32 arithmetic.  The 4
    bytes after the tag are read through the row rolled (past the row's
    last byte they wrap to its first).  Built 512 rows at a time, for
    memory."""
    b, c = comp.shape
    out = torch.empty(b, c, 4, dtype=torch.int32, device=comp.device)
    for r in range(0, b, 512):
        cb = comp[r : r + 512].to(torch.int64)
        nx = sum(torch.roll(cb, -k, dims=-1) << (8 * (k - 1)) for k in range(1, 5))
        kind, lraw = cb & 3, cb >> 2
        lk = torch.where(lraw < 60, 0, lraw - 59)
        lv = torch.where(lk == 0, lraw, torch.where(lk == 1, nx & 0xFF, torch.where(
            lk == 2, nx & 0xFFFF, torch.where(lk == 3, nx & 0xFFFFFF, _i32(nx)))))
        ll = _i32(lv + 1)
        is_lit = kind == 0
        blk = out[r : r + 512]
        blk[..., 0] = torch.where(is_lit, _i32(1 + lk + ll), torch.where(kind == 1, 2, torch.where(kind == 2, 3, 5)))
        blk[..., 1] = torch.where(is_lit, ll, torch.where(kind == 1, (lraw & 7) + 4, lraw + 1))
        blk[..., 2] = torch.where(is_lit, 0, torch.where(
            kind == 1, ((cb >> 5) << 8) | (nx & 0xFF), torch.where(kind == 2, nx & 0xFFFF, _i32(nx))))
        blk[..., 3] = torch.where(is_lit, 1 + lk, -1)
    return out


def _delimit(comp: torch.Tensor, comp_len: torch.Tensor, out_cap: int, s_max: int):
    """Element boundaries of every row, one element per step.

    Mirrors the JAX package's ``_delimit``: the tag is read with the
    index clamped into the row, the 4 bytes after it through the row
    rolled (past the row's last byte they wrap to its first); lengths and
    offsets are int32 (a 4-byte literal length or copy offset with its top
    bit set is negative, and sums wrap).  A step fails when it ends past
    ``comp_len``, a copy's offset is 0 or reaches before the output, or
    the output would pass ``out_cap``.  The JAX loop checks its ``s_max``
    bound every 8 steps, so a row stops unfinished only after a multiple
    of 8 steps >= s_max; elements from s_max on are not recorded.  The row
    decodes when it ended at ``comp_len`` and produced exactly the varint's
    length.

    Returns ((lit_src, lit_len, out_start, match_len, offset) int64[B,
    s_max], steps, total, ok bool, each [B]).
    """
    b, c = comp.shape
    dev = comp.device
    tbl = _element_table(comp)
    vlen, n_out = _read_varint(comp)
    comp_len = comp_len.to(torch.int64)
    rows = torch.arange(b, device=dev)
    seqs = torch.zeros(5, b, s_max + 1, dtype=torch.int64, device=dev)  # last column: dump
    p, o, s = vlen, torch.zeros_like(vlen), torch.zeros_like(vlen)
    done = (comp_len <= vlen) | (comp_len <= 0)
    ok = comp_len > 0
    s_stop = -(-s_max // 8) * 8

    step = 0
    while True:
        live = ~done & (s < s_stop)
        if step % lz77.CHECK_EVERY == 0 and not bool(live.any()):
            break
        step += 1
        at = p.clamp(0, c - 1)[:, None, None].expand(b, 1, 4)
        adv, add, off, lsrc = tbl.gather(1, at)[:, 0].to(torch.int64).unbind(1)
        is_lit = lsrc > 0
        p2 = _i32(p + adv)
        o2 = _i32(o + add)
        step_ok = (p2 <= comp_len) & (is_lit | ((off >= 1) & (off <= o))) & (o2 <= out_cap)
        col = torch.where(live & (s < s_max), s, s_max)
        seqs[:, rows, col] = torch.stack([torch.where(is_lit, _i32(p + lsrc), 0), torch.where(is_lit, add, 0),
                                          o, torch.where(is_lit, 0, add), off])
        ok = ok & (~live | step_ok)
        done = done | (live & ((p2 >= comp_len) | ~step_ok))
        p = torch.where(live, p2, p)
        o = torch.where(live, o2, o)
        s = torch.where(live, s + 1, s)
    ok &= done & (o == n_out) & (n_out <= out_cap)
    seqs = seqs[:, :, :s_max]
    return tuple(seqs), s, o, ok


def _decompress_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_capacity: int):
    """Plain PyTorch version of the decode kernel: (data uint8[B,
    out_capacity], lengths int32[B], statuses int32[B])."""
    s_max = comp.shape[1] // 2 + 2
    seqs, s, total, ok = _delimit(comp, comp_sizes, out_capacity, s_max)
    out = lz77.materialize(comp, seqs, total, out_capacity, num_seqs=s)
    out = torch.where(ok[:, None], out, 0)
    total = torch.where(ok, total, 0).to(torch.int32)
    status = torch.where(ok, int(Status.SUCCESS), int(Status.ERROR_CANNOT_DECOMPRESS))
    return out, total, status.to(torch.int32)


# ---------------------------------------------------------------------------
# public entry points


def compress(data: torch.Tensor, lengths: torch.Tensor, opts: SnappyOpts | None = None):
    """Batched Snappy compression.

    data: uint8[B, C]; lengths: int32[B], clamped to [0, C].  Returns
    (comp uint8[B, SNAPPYMAX], comp_sizes int32[B]), SNAPPYMAX =
    ``snappy_max_compressed_chunk_size(C)``.  ``opts`` is reserved.  A CPU
    batch takes the plain formulation, a CUDA batch the match-table and
    encode kernels.
    """
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be uint8[B, C]")
    if data.shape[1] == 0:
        raise ValueError("data must have at least one column (C > 0)")
    lengths = lengths.to(torch.int32).clamp(0, data.shape[1])
    if data.device.type == "cpu":
        return _compress_plain(data, lengths)
    from tpucomp_torch.kernels import lz77_cuda, snappy_cuda

    data = data.contiguous()
    table = lz77_cuda.match_table(data, lengths, 1, MAX_OFFSET, MIN_MATCH)
    return snappy_cuda.encode(data, lengths, table)


def decompress(comp: torch.Tensor, comp_sizes: torch.Tensor, opts: SnappyOpts | None = None,
               out_capacity: int = 65536):
    """Batched Snappy decompression.

    Returns (data uint8[B, out_capacity], lengths int32[B], statuses
    int32[B]); a corrupt stream, or one that does not fit
    ``out_capacity``, gives a zero row, length 0 and
    ERROR_CANNOT_DECOMPRESS.  ``opts`` is reserved.  A CPU batch takes the
    plain formulation, a CUDA batch the decode kernel.
    """
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError("comp must be uint8[B, CMAX]")
    if out_capacity < 1:
        raise ValueError("out_capacity must be at least 1")
    if comp.device.type == "cpu":
        return _decompress_plain(comp, comp_sizes, out_capacity)
    from tpucomp_torch.kernels import snappy_cuda

    return snappy_cuda.decompress(comp, comp_sizes, out_capacity)


def get_decompress_size(comp: torch.Tensor, comp_sizes: torch.Tensor,
                        opts: SnappyOpts | None = None) -> torch.Tensor:
    """Uncompressed byte count per stream from its varint header alone (0
    where ``comp_sizes <= 0``); the stream is not parsed.  Torch ops on the
    batch's device."""
    _, n = _read_varint(comp)
    return torch.where(comp_sizes.to(torch.int64) > 0, n, 0).to(torch.int32)
