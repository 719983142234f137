"""Dense LZ77 machinery of the LZ4 and Snappy codecs (counterpart of ``tpucomp.codecs.lz77``).

Every function works on a batch: ``data`` is uint8[B, C] and ``n`` the
int32[B] valid lengths.

  - match finding: one sort per row of the int64 key
    ``(4-byte window, invalid flag, position)`` gives the exact nearest
    previous occurrence of every position, with no hash collisions
    (``nearest_prev_occurrence``); ``candidate_tables`` turns it into the
    plain encoders' inputs, with each format's window and end limits.
    ``match_table`` is the plain version of the card's match-table kernel
    (``csrc/lz_match_table.cu``), which the CUDA encoders read instead:
    one uint16 distance per position, 0 for none.
  - match lengths (plain version only): exact, unbounded common-prefix
    lengths by a greedy walk over prefix-doubled suffix-id levels
    (``match_lengths``).
  - ``greedy_parse``: one greedy parse over the whole chunk, one sequence
    per step for every row at once.
  - ``materialize``: sequences to output bytes by pointer doubling, with
    self-overlapping copies resolved in closed form.
"""

from __future__ import annotations

import torch

from tpucomp_torch.utils import permute

MIN_MATCH = 4
MAX_OFFSET = 65535
LAST_VALID_MATCH = 13  # an LZ4 match starts at most at n - 13
INF = 1 << 30  # "no position" sentinel, as the JAX package's
CHECK_EVERY = 32  # steps between the per-row loops' host checks for the end


def _iota(c: int, device) -> torch.Tensor:
    return torch.arange(c, dtype=torch.int64, device=device)


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key ordered as (hi, lo) for hi, lo in [0, 2**32)."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def u32_keys(data: torch.Tensor) -> torch.Tensor:
    """Little-endian 4-byte window at every position, as int64 in
    [0, 2**32); windows wrap around the row end as the JAX package's do."""
    d = data.to(torch.int64)
    k = d.clone()
    for s in range(1, 4):
        k |= torch.roll(d, -s, dims=-1) << (8 * s)
    return k


def rev_cummin(x: torch.Tensor) -> torch.Tensor:
    """Suffix minimum over the last axis."""
    return x.flip(-1).cummin(-1).values.flip(-1)


def nearest_prev_occurrence(data: torch.Tensor, n: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """j[b, i] = largest j < i with data[j:j+4] == data[i:i+4], else -1.

    Positions past ``n - 4`` take no part.  ``stride`` > 1 restricts both
    ends to stride-aligned positions (element-aligned matches for typed
    data).  One sort per row of ``(window, invalid flag, position)``: in a
    window's group the valid positions come first, ascending, so each
    one's predecessor is its nearest previous occurrence.
    """
    b, c = data.shape
    i = _iota(c, data.device)
    invalid = i[None, :] > (n.to(torch.int64)[:, None] - MIN_MATCH)
    if stride > 1:
        invalid = invalid | (i % stride != 0)[None, :]
    key = _pair_key(u32_keys(data), i + invalid.to(torch.int64) * INF)
    del invalid
    key, pos = torch.sort(key, dim=-1)
    ok = (key & 0xFFFFFFFF) < INF
    same = (key[:, 1:] >> 32) == (key[:, :-1] >> 32)
    del key
    same &= ok[:, 1:] & ok[:, :-1]
    prev = torch.full_like(pos, -1)
    prev[:, 1:] = torch.where(same, pos[:, :-1], -1)
    del same, ok
    return torch.empty_like(prev).scatter_(1, pos, prev)


def candidate_tables(data: torch.Tensor, n: torch.Tensor, stride: int = 1, j: torch.Tensor | None = None,
                     max_offset: int = MAX_OFFSET, end_margin: int = LAST_VALID_MATCH):
    """An LZ77 encoder's candidate tables, int32[B, C] each.

    ``nmp[i]``: the first candidate position >= i, or ``INF``; ``dist[i]``:
    the distance to the nearest previous occurrence (any value where there
    is none).  A candidate has a previous occurrence at most ``max_offset``
    back and starts at most at ``n - end_margin``: 65535 and 13 for LZ4
    (its end rule), 32768 and 4 for Snappy.  ``j`` is
    ``nearest_prev_occurrence``'s result, computed here when not given.
    """
    if j is None:
        j = nearest_prev_occurrence(data, n, stride)
    i = _iota(data.shape[1], data.device)
    dist = i - j
    cand = (j >= 0) & (dist <= max_offset) & (i[None, :] <= n.to(torch.int64)[:, None] - end_margin)
    nmp = rev_cummin(torch.where(cand, i.to(torch.int32), INF).to(torch.int32))
    return nmp, dist.to(torch.int32)


def match_table(data: torch.Tensor, n: torch.Tensor, stride: int = 1, max_offset: int = MAX_OFFSET,
                end_margin: int = LAST_VALID_MATCH) -> torch.Tensor:
    """uint16[B, C]: the distance i - j to the nearest previous occurrence
    j of the window at i (``nearest_prev_occurrence``) where it is a
    candidate, at most ``max_offset`` back and i <= n - end_margin, else 0
    (a distance is never 0).  The limits are ``candidate_tables``'."""
    j = nearest_prev_occurrence(data, n, stride)
    i = _iota(data.shape[1], data.device)
    dist = i - j
    keep = (j >= 0) & (dist <= max_offset) & (i[None, :] <= n.to(torch.int64)[:, None] - end_margin)
    return torch.where(keep, dist, 0).to(torch.uint16)


def suffix_id_levels(data: torch.Tensor, max_h: int):
    """Prefix-equality ids by prefix doubling: [(h, ids int32[B, C])] for
    h = 8, 16, ..., the first >= max_h.  For a + h and b + h within the
    valid length, ids[a] == ids[b] iff data[a:a+h] == data[b:b+h]; ids of
    windows that run past the row are arbitrary.  One sort per level."""
    c = data.shape[-1]
    cur = u32_keys(data)
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


def match_lengths(data: torch.Tensor, n: torch.Tensor, j: torch.Tensor, max_offset: int = MAX_OFFSET):
    """Common-prefix length of data[i:n] and data[j[i]:n], exact and
    unbounded (the levels reach c/2, so the walk covers any match in the
    row).  Returns (mlen, dist, cand) as int64, int64, bool [B, C]."""
    b, c = data.shape
    i = _iota(c, data.device)[None, :]
    dist = i - j
    cand = (j >= 0) & (dist <= max_offset)
    id1 = data.to(torch.int64)
    id2 = id1 | (torch.roll(id1, -1, dims=-1) << 8)
    id4 = u32_keys(data)
    walk = suffix_id_levels(data, max(8, c // 2))[::-1] + [(4, id4), (2, id2), (1, id1)]
    # the candidate shares the 4-byte window, so the walk starts at 4;
    # descending levels {H..8, 4, 2, 1} reach any length in [4, 2H + 3]
    lcp = torch.where(cand, 4, 0)
    jc = torch.where(cand, j, 0)
    nn = n.to(torch.int64)[:, None]
    for h, ids in walk:
        a = i + lcp
        bb = jc + lcp
        same = ids.gather(1, a.clamp(0, c - 1)) == ids.gather(1, bb.clamp(0, c - 1))
        lcp = torch.where(cand & (a + h <= nn) & same, lcp + h, lcp)
    return torch.where(cand, lcp, 0), dist, cand


def greedy_parse(nmp: torch.Tensor, m_clamped: torch.Tensor, dist: torch.Tensor, n: torch.Tensor,
                 s_max: int):
    """Greedy parse of every row over one parse block spanning the chunk.

    ``nmp[i]`` is the first usable match position >= i (``INF`` if none),
    ``m_clamped`` the match length there (with the format's end clamps
    applied).  From anchor p the next sequence is the literals [p, q) and
    the match at q = nmp[p]; the parse then resumes at q + m.  A final
    literals-only sequence takes [p, n).  Returns (lit_start, lit_len,
    match_len, offset) as int64[B, s_max] and num_seqs int64[B].
    """
    b, c = nmp.shape
    dev = nmp.device
    nn = n.to(torch.int64).clamp(min=0)
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
    # final literals-only sequence [p, n)
    seqs[:, rows, cnt] = torch.stack([p, nn - p, torch.zeros_like(p), torch.zeros_like(p)])
    seqs = seqs[:, :, :s_max]
    return seqs[0], seqs[1], seqs[2], seqs[3], cnt + 1


def materialize(src_bytes: torch.Tensor, seqs, total_out: torch.Tensor, out_cap: int,
                num_seqs: torch.Tensor) -> torch.Tensor:
    """Expand sequences into output bytes, uint8[B, out_cap].

    ``seqs`` = (lit_src, lit_len, out_start, match_len, offset), each
    [B, S]; literal bytes come from ``src_bytes`` (the compressed rows),
    read with the index clamped into the row.  Every match position jumps
    out of its (possibly self-overlapping) copy in closed form; chains of
    matches resolve by pointer doubling, at most 24 rounds.
    """
    lit_src, lit_len, out_start, match_len, offset = (x.to(torch.int64) for x in seqs)
    b, s = lit_src.shape
    dev = src_bytes.device
    si = torch.arange(s, device=dev)[None, :]
    valid = ((lit_len > 0) | (match_len > 0)) & (si < num_seqs.to(torch.int64)[:, None])
    p_os, p_dst, p_off, p_lsrc = permute.fill_from_markers(
        out_start, valid, [out_start, out_start + lit_len, offset, lit_src], out_cap)
    p_off = p_off.clamp(min=1)
    t = _iota(out_cap, dev)[None, :]
    total = total_out.to(torch.int64)[:, None]
    # positions past the real output count as literals, so they never keep
    # the resolution loop alive
    is_lit = (t < p_dst) | (t >= total)
    jump = torch.where(is_lit, ~t, (p_dst - p_off + (t - p_dst) % p_off).clamp(0, out_cap - 1))
    del p_dst, p_off
    for _ in range(24):
        live = jump >= 0
        if not bool(live.any()):
            break
        jump = torch.where(live, jump.gather(1, jump.clamp(0, out_cap - 1)), jump)
    lit_pos = ~jump
    src = (p_lsrc - p_os).gather(1, lit_pos.clamp(0, out_cap - 1)) + lit_pos
    out = src_bytes.gather(1, src.clamp(0, src_bytes.shape[1] - 1))
    return torch.where(t < total, out, 0).to(torch.uint8)
