"""Batched LZ4 block codec (counterpart of ``tpucomp.codecs.lz4``).

Streams are standard LZ4 blocks: sequences of [token][literal-length
LSIC][literals][u16 LE offset][match-length LSIC], the last sequence
literals only, the last 5 bytes literals, matches starting at least 12
bytes before the end, offsets at most 65535.

compress: the pure greedy parse over the exact nearest previous
occurrence of every position, with exact, unbounded match extension.  It
emits the same bytes as the JAX package's Pallas kernel
(``tpucomp.kernels.lz_pallas.compress``) and the uncapped sequential
oracle, not those of its XLA path, which clamps parses to 4 KB blocks.

  - a CUDA batch runs the match-table kernel and the encode kernel
    (``kernels/lz4_cuda.py``), which find their candidates on the card;
  - a CPU batch runs the plain version: the candidate tables
    (``lz77.candidate_tables``), exact match lengths
    (``lz77.match_lengths``), ``lz77.greedy_parse`` with the LZ4 end
    rules, and position-driven emission (``_emit``).

decompress: returns what the JAX package's XLA path returns, data,
lengths and statuses, including on corrupt input: a CUDA batch runs the
decode kernel, a CPU batch the plain version (``_delimit``, one sequence
per step for all rows, then ``lz77.materialize``).  One exception: the
XLA path packs LSIC byte counts into 9 (match) and 10 (literal) bits of
its parse tables, so it rejects or misreads LSIC runs of 512 and 1024
bytes and more (matches of ~130 KB, literal runs of ~261 KB); the port
reads them as the format says.
"""

from __future__ import annotations

import torch

from tpucomp_torch.codecs import lz77
from tpucomp_torch.core.options import LZ4Opts
from tpucomp_torch.core.sizing import lz4_max_compressed_chunk_size
from tpucomp_torch.core.types import Status, width_of
from tpucomp_torch.utils import permute

MIN_MATCH = 4
LAST_LITERALS = 5  # the last 5 bytes of a block are literals


# ---------------------------------------------------------------------------
# compression


def _lsic_len(v: torch.Tensor) -> torch.Tensor:
    """LSIC extension bytes of a length field value v >= 0 (0 below 15)."""
    return torch.where(v >= 15, torch.div(v - 15, 255, rounding_mode="floor") + 1, 0)


def _emit(data, lit_start, lit_len, match_len, offset, num_seqs, out_max: int):
    """Position-driven emission: every output byte finds its sequence and
    its place in it (token, LSIC, literal, offset) from the sequences'
    output offsets."""
    b, s_max = lit_start.shape
    dev = data.device
    si = torch.arange(s_max, device=dev)[None, :]
    valid = si < num_seqs[:, None]
    llb = _lsic_len(lit_len)
    mlb = torch.where(match_len > 0, _lsic_len(match_len - MIN_MATCH), 0)
    seq_bytes = torch.where(valid, 1 + llb + lit_len + torch.where(match_len > 0, 2 + mlb, 0), 0)
    inc = seq_bytes.cumsum(-1)
    out_start = inc - seq_bytes
    total = inc[:, -1]
    sid = permute.fill_from_markers(out_start, valid & (seq_bytes > 0), [si.expand(b, s_max)], out_max)[0]

    def at(x):
        return x.gather(1, sid)

    p_ll, p_llb, p_ml, p_mlb, p_off = at(lit_len), at(llb), at(match_len), at(mlb), at(offset)
    u = torch.arange(out_max, device=dev)[None, :] - at(out_start)
    lit0 = 1 + p_llb
    off0 = lit0 + p_ll
    mlx0 = off0 + 2
    token = (p_ll.clamp(max=15) << 4) | torch.where(p_ml > 0, (p_ml - MIN_MATCH).clamp(max=15), 0)
    # LSIC bytes: all 255 but the last
    lit_ext = torch.where(u - 1 < p_llb - 1, 255, p_ll - 15 - 255 * (p_llb - 1))
    m_ext = torch.where(u - mlx0 < p_mlb - 1, 255, p_ml - MIN_MATCH - 15 - 255 * (p_mlb - 1))
    lit_byte = data.gather(1, (at(lit_start) + u - lit0).clamp(0, data.shape[1] - 1)).to(torch.int64)
    off_byte = torch.where(u == off0, p_off & 0xFF, (p_off >> 8) & 0xFF)
    val = torch.where(u == 0, token,
                      torch.where(u < lit0, lit_ext,
                                  torch.where(u < off0, lit_byte,
                                              torch.where(u < mlx0, off_byte, m_ext))))
    t = torch.arange(out_max, device=dev)[None, :]
    return torch.where(t < total[:, None], val, 0).to(torch.uint8), total


def _compress_plain(data: torch.Tensor, lengths: torch.Tensor, stride: int = 1):
    """Plain PyTorch version of the encode kernel: (comp uint8[B, LZ4MAX],
    comp_sizes int32[B]) for lengths in [0, C]."""
    b, c = data.shape
    n = lengths.to(torch.int64)
    j = lz77.nearest_prev_occurrence(data, n, stride)
    nmp, dist = lz77.candidate_tables(data, n, stride, j=j)
    mlen = lz77.match_lengths(data, n, j)[0]
    del j
    i = torch.arange(c, device=data.device)[None, :]
    m_clamped = torch.minimum(mlen, (n[:, None] - LAST_LITERALS - i).clamp(min=0))
    del mlen
    seqs = lz77.greedy_parse(nmp, m_clamped, dist.to(torch.int64), n, c // MIN_MATCH + 2)
    del nmp, dist, m_clamped
    out, total = _emit(data, *seqs, lz4_max_compressed_chunk_size(c))
    return out, torch.where(n > 0, total, 0).to(torch.int32)


# ---------------------------------------------------------------------------
# decompression


def _delimit(comp: torch.Tensor, comp_len: torch.Tensor, out_cap: int, s_max: int):
    """Sequence boundaries of every row, one sequence per step.

    Mirrors the JAX package's ``_delimit``: bytes are read through the row
    with the index clamped to [0, CMAX - 1]; an LSIC 255-run stops at the
    row's last byte and takes that byte's value; the byte after the row's
    last is its first (the JAX tables are rolled).  A step fails when its
    literals run past ``comp_len``, its offset is 0 or reaches before the
    output, its offset or match LSIC runs past ``comp_len``, or the output
    would pass ``out_cap``.  The JAX loop checks its ``s_max`` bound every
    8 steps, so a row stops unfinished only after a multiple of 8 steps
    >= s_max; sequences from s_max on are not recorded.

    Returns ((lit_src, lit_len, out_start, match_len, offset) int64[B,
    s_max], steps, total, ok bool, each [B]).  Arithmetic is int64; the
    JAX package's int32 could wrap only on LSIC runs of millions of bytes.
    """
    b, c = comp.shape
    dev = comp.device
    i = torch.arange(c, device=dev)[None, :]
    cb = comp.to(torch.int64)
    nn = lz77.rev_cummin(torch.where(cb != 255, i, lz77.INF)).clamp(max=c - 1)
    run255 = nn - i
    ext_total = 255 * run255 + cb.gather(1, nn.long())
    ext_bytes = run255 + 1
    del nn, run255
    lnib = cb >> 4
    ll_tbl = torch.where(lnib == 15, 15 + torch.roll(ext_total, -1, dims=-1), lnib)
    lb_tbl = torch.where(lnib == 15, torch.roll(ext_bytes, -1, dims=-1), 0)
    off_tbl = cb | (torch.roll(cb, -1, dims=-1) << 8)
    mb_tbl = torch.roll(ext_bytes, -2, dims=-1)
    mt_tbl = torch.roll(ext_total, -2, dims=-1)
    del lnib, ext_total, ext_bytes

    comp_len = comp_len.to(torch.int64)
    rows = torch.arange(b, device=dev)
    seqs = torch.zeros(5, b, s_max + 1, dtype=torch.int64, device=dev)  # last column: dump
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    p, o, s = zero, zero, zero
    done = comp_len <= 0
    ok = comp_len >= 0
    s_stop = -(-s_max // 8) * 8

    def at(tbl, x):
        return tbl.gather(1, x.clamp(0, c - 1)[:, None])[:, 0]

    step = 0
    while True:
        live = ~done & (s < s_stop)
        if step % lz77.CHECK_EVERY == 0 and not bool(live.any()):
            break
        step += 1
        token = at(cb, p)
        lb = at(lb_tbl, p)
        llen = at(ll_tbl, p)
        src = p + 1 + lb
        q = src + llen
        is_last = q >= comp_len
        off = at(off_tbl, q)
        mnib = token & 15
        has_m = mnib == 15
        mb = torch.where(has_m, at(mb_tbl, q), 0)
        mlen = torch.where(is_last, 0, MIN_MATCH + torch.where(has_m, 15 + at(mt_tbl, q), mnib))
        step_ok = q <= comp_len
        step_ok &= is_last | ((off >= 1) & (off <= o + llen))
        step_ok &= is_last | (q + 2 + mb <= comp_len)
        o2 = o + llen + mlen
        step_ok &= o2 <= out_cap
        col = torch.where(live & (s < s_max), s, s_max)
        seqs[:, rows, col] = torch.stack([src, llen, o, mlen, off])
        ok = ok & (~live | step_ok)
        p = torch.where(live, torch.where(is_last, comp_len, q + 2 + mb), p)
        o = torch.where(live, o2, o)
        s = torch.where(live, s + 1, s)
        done = done | (live & (is_last | ~step_ok))
    ok &= done  # ran out of steps without a last sequence: corrupt
    seqs = seqs[:, :, :s_max]
    return tuple(seqs), s, o, ok


def _decompress_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_capacity: int):
    """Plain PyTorch version of the decode kernel: (data uint8[B,
    out_capacity], lengths int32[B], statuses int32[B])."""
    s_max = comp.shape[1] // 3 + 2
    seqs, s, total, ok = _delimit(comp, comp_sizes, out_capacity, s_max)
    out = lz77.materialize(comp, seqs, total, out_capacity, num_seqs=s)
    out = torch.where(ok[:, None], out, 0)
    total = torch.where(ok, total, 0).to(torch.int32)
    status = torch.where(ok, int(Status.SUCCESS), int(Status.ERROR_CANNOT_DECOMPRESS))
    return out, total, status.to(torch.int32)


# ---------------------------------------------------------------------------
# public entry points


def _stride(opts: LZ4Opts | None) -> int:
    if opts is None:
        return 1
    opts.validate()
    return width_of(opts.data_type)


def compress(data: torch.Tensor, lengths: torch.Tensor, opts: LZ4Opts | None = None):
    """Batched LZ4 compression.

    data: uint8[B, C]; lengths: int32[B], clamped to [0, C].  Returns
    (comp uint8[B, LZ4MAX], comp_sizes int32[B]), LZ4MAX =
    ``lz4_max_compressed_chunk_size(C)``; an empty row compresses to 0
    bytes.  ``opts.data_type`` sets the match granularity (``opts=None``:
    bytes).  A CPU batch takes the plain formulation, a CUDA batch the
    match-table and encode kernels.
    """
    stride = _stride(opts)
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be uint8[B, C]")
    lengths = lengths.to(torch.int32).clamp(0, data.shape[1])
    if data.device.type == "cpu":
        return _compress_plain(data, lengths, stride)
    from tpucomp_torch.kernels import lz4_cuda, lz77_cuda

    data = data.contiguous()
    table = lz77_cuda.match_table(data, lengths, stride, lz77.MAX_OFFSET, lz77.LAST_VALID_MATCH)
    return lz4_cuda.encode(data, lengths, table)


def decompress(comp: torch.Tensor, comp_sizes: torch.Tensor, opts: LZ4Opts | None = None,
               out_capacity: int = 65536):
    """Batched LZ4 decompression.

    Returns (data uint8[B, out_capacity], lengths int32[B], statuses
    int32[B]); a corrupt stream, or one that does not fit
    ``out_capacity``, gives a zero row, length 0 and
    ERROR_CANNOT_DECOMPRESS.  ``opts`` is not read (streams are
    self-delimiting).  A CPU batch takes the plain formulation, a CUDA
    batch the decode kernel.
    """
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError("comp must be uint8[B, CMAX]")
    if out_capacity < 1:
        raise ValueError("out_capacity must be at least 1")
    if comp.device.type == "cpu":
        return _decompress_plain(comp, comp_sizes, out_capacity)
    from tpucomp_torch.kernels import lz4_cuda

    return lz4_cuda.decompress(comp, comp_sizes, out_capacity)


def get_decompress_size(comp: torch.Tensor, comp_sizes: torch.Tensor, opts: LZ4Opts | None = None,
                        out_capacity: int = 1 << 24) -> torch.Tensor:
    """Uncompressed byte count per stream (0 for a corrupt stream or one
    larger than ``out_capacity``): the parse alone, torch ops on the
    batch's device."""
    _, _, total, ok = _delimit(comp, comp_sizes, out_capacity, comp.shape[1] // 3 + 2)
    return torch.where(ok, total, 0).to(torch.int32)
