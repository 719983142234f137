"""Plain reference of the LZ4 compressor: the bytes tpucomp emits.

A frozen copy, in plain PyTorch, of the port's plain LZ4 encoder
(``codecs/lz4.py`` ``_compress_plain`` over ``codecs/lz77.py``), which the
port's tests hold to the JAX package's Pallas kernel and to a sequential
oracle.  The parse: per partition, the pure greedy parse over the exact
nearest previous occurrence of every 4-byte window (one sort per row, no
hash collisions), matches at most ``MAX_OFFSET`` back and starting at
most 13 bytes before the end, extended exactly and without bound, the
last 5 bytes literals; standard LZ4 block sequences.

``max_offset`` below 65535 is the control: still valid, lossless LZ4,
but a shorter match window than the configuration states, so not
tpucomp's bytes.
"""

from __future__ import annotations

import struct

import torch

from benchmark.reference import _plain

MIN_MATCH = 4
MAX_OFFSET = 65535
LAST_VALID_MATCH = 13  # a match starts at most at n - 13
LAST_LITERALS = 5  # the last 5 bytes are literals
INF = 1 << 30
CHECK_EVERY = 32  # parse steps between host checks for the end
CONTROL = {"max_offset": 4095}  # the control: a 4 KB match window in place of 64 KB
ARTIFACT_FORMAT = 0  # the format byte of a manager's artifact


def artifact_header(opts: dict) -> bytes:
    """The format's own header in a manager's artifact: u32 data type."""
    return struct.pack("<I", _plain.TYPE_BY_NAME[opts["data_type"]])


def max_compressed_size(n: int) -> int:
    """The worst-case stream of an n-byte partition: n + 1 + ceil(n/255), to 8."""
    return _plain.round_up_to(n + 1 + (n + 254) // 255, 8)


def _iota(c: int, device) -> torch.Tensor:
    return torch.arange(c, dtype=torch.int64, device=device)


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return (hi - (1 << 31)) * (1 << 32) + lo


def _u32_keys(data: torch.Tensor) -> torch.Tensor:
    """Little-endian 4-byte window at every position (wrapping at the row end)."""
    d = data.to(torch.int64)
    k = d.clone()
    for s in range(1, 4):
        k |= torch.roll(d, -s, dims=-1) << (8 * s)
    return k


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return x.flip(-1).cummin(-1).values.flip(-1)


def _nearest_prev_occurrence(data: torch.Tensor, n: torch.Tensor, stride: int) -> torch.Tensor:
    """j[b, i] = largest j < i with the same 4-byte window, else -1."""
    b, c = data.shape
    i = _iota(c, data.device)
    invalid = i[None, :] > (n[:, None] - MIN_MATCH)
    if stride > 1:
        invalid = invalid | (i % stride != 0)[None, :]
    key = _pair_key(_u32_keys(data), i + invalid.to(torch.int64) * INF)
    del invalid
    key, pos = torch.sort(key, dim=-1)
    ok = (key & 0xFFFFFFFF) < INF
    same = (key[:, 1:] >> 32) == (key[:, :-1] >> 32)
    del key
    same &= ok[:, 1:] & ok[:, :-1]
    prev = torch.full_like(pos, -1)
    prev[:, 1:] = torch.where(same, pos[:, :-1], -1)
    return torch.empty_like(prev).scatter_(1, pos, prev)


def _suffix_id_levels(data: torch.Tensor, max_h: int):
    """Prefix-equality ids by prefix doubling, h = 8, 16, ... >= max_h."""
    cur = _u32_keys(data)
    levels = []
    h = 4
    while h < max_h:
        key = _pair_key(cur, torch.roll(cur, -h, dims=-1))
        key, pos = torch.sort(key, dim=-1)
        neq = torch.ones_like(key, dtype=torch.int32)
        neq[:, 1:] = (key[:, 1:] != key[:, :-1]).to(torch.int32)
        del key
        cur = torch.empty_like(pos).scatter_(1, pos, neq.cumsum(-1, dtype=torch.int64))
        del pos, neq
        h *= 2
        levels.append((h, cur.to(torch.int32)))
    return levels


def _match_lengths(data: torch.Tensor, n: torch.Tensor, j: torch.Tensor, max_offset: int) -> torch.Tensor:
    """Exact, unbounded common-prefix length of data[i:n] and data[j[i]:n]."""
    b, c = data.shape
    i = _iota(c, data.device)[None, :]
    cand = (j >= 0) & (i - j <= max_offset)
    id1 = data.to(torch.int64)
    id2 = id1 | (torch.roll(id1, -1, dims=-1) << 8)
    walk = _suffix_id_levels(data, max(8, c // 2))[::-1] + [(4, _u32_keys(data)), (2, id2), (1, id1)]
    lcp = torch.where(cand, 4, 0)
    jc = torch.where(cand, j, 0)
    nn = n[:, None]
    for h, ids in walk:
        a = i + lcp
        bb = jc + lcp
        same = ids.gather(1, a.clamp(0, c - 1)) == ids.gather(1, bb.clamp(0, c - 1))
        lcp = torch.where(cand & (a + h <= nn) & same, lcp + h, lcp)
    return torch.where(cand, lcp, 0)


def _greedy_parse(nmp, m_clamped, dist, n, s_max: int):
    """From anchor p: literals [p, q) and the match at q = nmp[p], then
    resume at q + m; a final literals-only sequence takes [p, n)."""
    b, c = nmp.shape
    dev = nmp.device
    nn = n.clamp(min=0)
    rows = torch.arange(b, device=dev)
    seqs = torch.zeros(4, b, s_max + 1, dtype=torch.int64, device=dev)  # last column: dump
    p = torch.zeros(b, dtype=torch.int64, device=dev)
    cnt = torch.zeros(b, dtype=torch.int64, device=dev)
    done = nn <= 0
    step = 0
    while True:
        if step % CHECK_EVERY == 0 and bool(done.all()):
            break
        step += 1
        q = nmp.gather(1, p.clamp(0, c - 1)[:, None])[:, 0].to(torch.int64)
        fin = (q >= nn) | (p >= nn)
        qc = torch.minimum(q, nn).clamp(0, c - 1)[:, None]
        m = torch.where(fin, 0, m_clamped.gather(1, qc)[:, 0])
        off = torch.where(fin, 0, dist.gather(1, qc)[:, 0])
        rec = ~done & ~fin
        col = torch.where(rec, cnt, s_max)
        seqs[:, rows, col] = torch.stack([p, q - p, m, off])
        cnt += rec.to(torch.int64)
        p = torch.where(rec, q + m, p)
        done = done | fin
    seqs[:, rows, cnt] = torch.stack([p, nn - p, torch.zeros_like(p), torch.zeros_like(p)])
    seqs = seqs[:, :, :s_max]
    return seqs[0], seqs[1], seqs[2], seqs[3], cnt + 1


def _lsic_len(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 15, torch.div(v - 15, 255, rounding_mode="floor") + 1, 0)


def _emit(data, lit_start, lit_len, match_len, offset, num_seqs, out_max: int):
    """Every output byte finds its sequence and its place in it."""
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
    sid = _plain.fill_from_markers(out_start, valid & (seq_bytes > 0), [si.expand(b, s_max)], out_max)[0]

    def at(x):
        return x.gather(1, sid)

    p_ll, p_llb, p_ml, p_mlb, p_off = at(lit_len), at(llb), at(match_len), at(mlb), at(offset)
    u = torch.arange(out_max, device=dev)[None, :] - at(out_start)
    lit0 = 1 + p_llb
    off0 = lit0 + p_ll
    mlx0 = off0 + 2
    token = (p_ll.clamp(max=15) << 4) | torch.where(p_ml > 0, (p_ml - MIN_MATCH).clamp(max=15), 0)
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


def _compress_block(data: torch.Tensor, lengths: torch.Tensor, stride: int, max_offset: int):
    b, c = data.shape
    n = lengths.to(torch.int64).clamp(0, c)
    j = _nearest_prev_occurrence(data, n, stride)
    i = _iota(c, data.device)
    dist = i - j
    cand = (j >= 0) & (dist <= max_offset) & (i[None, :] <= n[:, None] - LAST_VALID_MATCH)
    nmp = _rev_cummin(torch.where(cand, i.to(torch.int32), INF).to(torch.int32))
    del cand
    mlen = _match_lengths(data, n, j, max_offset)
    del j
    m_clamped = torch.minimum(mlen, (n[:, None] - LAST_LITERALS - i[None, :]).clamp(min=0))
    del mlen
    seqs = _greedy_parse(nmp, m_clamped, dist, n, c // MIN_MATCH + 2)
    del nmp, dist, m_clamped
    out, total = _emit(data, *seqs, max_compressed_size(c))
    return out, torch.where(n > 0, total, 0).to(torch.int32)


def compress(data: torch.Tensor, lengths: torch.Tensor, opts: dict, block_rows: int = 4096,
             max_offset: int = MAX_OFFSET):
    """(streams uint8[B, max_compressed_size(C)], sizes int32[B]) of
    uint8[B, C] partitions with valid ``lengths``, under the LZ4 options
    ``opts`` (``{"data_type": name}``: matches on element boundaries)."""
    stride = _plain.WIDTH_OF_TYPE[_plain.TYPE_BY_NAME[opts["data_type"]]]
    return _plain.in_blocks(lambda d, n: _compress_block(d, n, stride, max_offset), data, lengths, block_rows)
