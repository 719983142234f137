"""LZ4 inputs shared by the port's tests and chip_smoke.py.

numpy and the pure-Python oracle only: the same seeded batches go through
the JAX package and the port (tests/test_torch_lz4.py), and through the
port's plain versions and its CUDA kernels (tests/test_torch_lz4_kernels.py,
chip_smoke.py).  Each function returns dense numpy batches.

The cases held against the JAX package on the CPU stay at C = 2048 (one
at 64 KB); the kernel cases add chunks up to 1 MB and one of 16 MB, which
only the card runs.
"""

from __future__ import annotations

import json
import os

import numpy as np

from oracles.lz4_oracle import lz4_compress_oracle
from tpucomp_torch.core.sizing import lz4_max_compressed_chunk_size as lz4_max

C = 2048  # the capacity of the cases held against the JAX package
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "lz4_golden.json")


def batch(rows, cap: int):
    """Rows (uint8 arrays or bytes) -> (uint8[B, cap], int32[B])."""
    arr = np.zeros((len(rows), cap), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        r = np.frombuffer(r, np.uint8) if isinstance(r, (bytes, bytearray)) else np.asarray(r, np.uint8)
        arr[i, : r.size] = r
        lens[i] = r.size
    return arr, lens


def profiles(rng, c: int = C) -> dict:
    """The profiles of tests/test_lz_pallas.py and tests/test_lz4.py."""
    text = np.frombuffer((b"the quick brown fox jumps over the lazy dog. " * (c // 45 + 1))[:c], np.uint8)
    block = rng.integers(0, 256, 256, dtype=np.uint8)
    return {
        "runs": np.repeat(rng.integers(0, 5, c), rng.integers(1, 30, c)).astype(np.uint8)[:c],
        "words": rng.choice(np.frombuffer(b"the quick brown fox jumps over a dog ", np.uint8), c),
        "random": rng.integers(0, 256, c, dtype=np.uint8),
        "abc": np.tile(np.frombuffer(b"abc", np.uint8), c // 3 + 1)[: c - 5],
        "zeros": np.zeros(c, np.uint8),
        "text": text,
        "period11": np.tile(np.arange(11, dtype=np.uint8), c // 11 + 1)[:c],
        "semi": np.where(rng.random(c) < 0.8, np.tile(np.arange(16, dtype=np.uint8), c // 16 + 1)[:c],
                         rng.integers(0, 256, c)).astype(np.uint8),
        "repeat256": np.tile(block, c // 256 + 1)[:c],
        "half_dup": np.concatenate([rng.integers(0, 256, c // 2, dtype=np.uint8)] * 2)[:c],
    }


def edge_rows(rng) -> dict:
    """Tiny and empty rows, and literal and match lengths at the LSIC edges
    (tests/test_lz4.py::test_small_sizes, test_lsic_boundaries)."""
    rows = {f"small{n}": rng.integers(0, 4, n).astype(np.uint8) for n in (0, 1, 2, 5, 12, 13, 16, 17, 64)}
    for ll in (14, 15, 16, 269, 270, 271):
        rows[f"lit{ll}"] = np.concatenate([rng.integers(0, 256, ll, dtype=np.uint8), np.zeros(64, np.uint8)])
    for ml in (18, 19, 20, 273, 274):
        base = rng.integers(0, 256, 32, dtype=np.uint8)
        rows[f"match{ml}"] = np.concatenate([base, np.tile(base[:16], ml // 16 + 2)[:ml],
                                             rng.integers(0, 256, 16, dtype=np.uint8)])
    return rows


def compress_rows(rng, c: int = C):
    """(names, uint8[B, c], int32[B]): the profiles and the edge rows."""
    rows = {**profiles(rng, c), **edge_rows(rng)}
    arr, lens = batch(list(rows.values()), c)
    return list(rows), arr, lens


def typed_rows(rng, c: int = C):
    """Element-typed data with repeats at element granularity, for strides
    2 and 4 (tests/test_lz4.py::test_typed_granularity)."""
    rows = []
    for w, t in ((2, np.uint16), (4, np.uint32)):
        vals = rng.integers(0, 50, c // w).astype(t)
        vals[100:300] = vals[0:200]
        rows.append(vals.view(np.uint8))
    return batch(rows, c)


def merged_table_row():
    """tests/test_lz4.py::test_merged_table_boundary_matches: matches at
    positions >= 32768 and at distances near 65535, in a 64 KB chunk."""
    rng = np.random.default_rng(9)
    base = rng.integers(1, 255, 65536, dtype=np.uint8)
    base[65500:65516] = base[0:16]
    base[40000:40032] = base[35000:35032]
    return batch([base], 65536)


def golden_streams():
    """(names, comp uint8[B, CMAX], sizes int32[B], expected outputs) of
    tests/fixtures/lz4_golden.json."""
    with open(FIXTURES) as f:
        cases = json.load(f)
    names = sorted(cases)
    streams = [bytes.fromhex(cases[k]["stream"]) for k in names]
    outs = [bytes.fromhex(cases[k]["out"]) for k in names]
    comp, sizes = batch(streams, max(map(len, streams)) + 8)
    return names, comp, sizes, outs


def oracle_streams(arr, lens, cmax: int):
    """The uncapped oracle's stream of every row."""
    return batch([lz4_compress_oracle(arr[i, : lens[i]].tobytes()) for i in range(len(lens))], cmax)


def garbage_batch(rng, b: int, cmax: int, cap: int = C):
    """tests/test_kernel_fuzz.py::_garbage_batch with the oracle's streams:
    pure garbage, truncated valid streams and bit-flipped valid streams."""
    comps = np.zeros((b, cmax), np.uint8)
    sizes = np.zeros((b,), np.int32)
    for i in range(b):
        kind = rng.integers(0, 3)
        if kind == 0:
            n = int(rng.integers(1, cmax + 1))
            comps[i, :n] = rng.integers(0, 256, n)
            sizes[i] = n
        else:
            v = lz4_compress_oracle(rng.integers(0, 64, cap, dtype=np.uint8).tobytes())
            n = min(len(v), cmax)
            comps[i, :n] = np.frombuffer(v[:n], np.uint8)
            if kind == 1:
                sizes[i] = max(1, n // int(rng.integers(2, 5)))  # truncation
            else:
                k = int(rng.integers(0, max(1, n - 1)))
                comps[i, k] ^= 1 << int(rng.integers(0, 8))  # bit flip
                sizes[i] = n
    return comps, sizes


def corrupt_streams(comp_row: np.ndarray, size: int):
    """Hand-made faults (tests/test_lz4.py::test_corrupt_streams) around one
    valid stream: truncation, garbage, an offset past the output, offset 0,
    a match LSIC that overflows the output, a negative and a zero size,
    and a size past the row.  Returns (labels, comp uint8[B, CMAX],
    sizes int32[B])."""
    rng = np.random.default_rng(5)
    cmax = comp_row.shape[0]
    bad = np.zeros(cmax, np.uint8)
    bad[:4] = (0x12, 0x41, 0xFF, 0xFF)  # 1 literal, match 6 at offset 65535
    zero_off = bad.copy()
    zero_off[2:4] = 0
    over = np.zeros(cmax, np.uint8)
    over[:4] = (0x1F, ord("x"), 1, 0)
    over[4:300] = 255  # a match length without end
    cases = [
        ("truncated", comp_row, max(1, size // 2)),
        ("garbage", rng.integers(0, 256, cmax, dtype=np.uint8), size),
        ("offset_past_output", bad, 8),
        ("offset_zero", zero_off, 8),
        ("lsic_overflow", over, 301),
        ("negative_size", comp_row, -3),
        ("zero_size", comp_row, 0),
        ("size_past_row", comp_row, cmax + 40),
    ]
    return ([c[0] for c in cases], np.stack([c[1] for c in cases]),
            np.array([c[2] for c in cases], np.int32))


def s_max_overrun():
    """A 60-byte row whose stream reads past the row end and finishes after
    the JAX loop's sequence bound: s_max = 60 // 3 + 2 = 22 sequences are
    recorded, the 23rd is not, and the 24th (the last one the loop runs,
    8 steps at a time) ends the stream.  One literal 'A', a match of 7924
    at offset 1, eight matches of 4 at offset 1, then, read clamped to the
    row's last byte (token 0x00, offset 0x1F00 through the wrapped byte),
    matches of 4 at offset 7936 up to comp_len 103.  Returns (comp
    uint8[1, 60], sizes int32[1], out_capacity)."""
    row = bytes([0x1F, ord("A"), 1, 0]) + bytes([255]) * 31 + bytes([0]) + bytes([0, 1, 0]) * 8
    assert len(row) == 60
    comp, _ = batch([row], 60)
    return comp, np.array([103], np.int32), 8192


def handoff_rows(rng, n: int = 2000, fail_at: int = 200):
    """Four rows for one CTA of the decode kernel (a walker and a copier
    warp a row), as unlike as rows get: n 5-byte sequences (two literals, a
    match of 4 at offset 2) then one literal; one literal run of 3,000
    random bytes; an empty stream; the first row with the offset of
    sequence ``fail_at`` set to 0, so that the row fails after
    ``fail_at // 16`` hand-offs of 16 sequences.  Returns (comp uint8[4,
    CMAX], sizes int32[4], out_capacity, the failing row's index)."""
    lits = rng.integers(0, 256, (n, 2), dtype=np.uint8)
    seqs = np.concatenate([np.full((n, 1), 0x20, np.uint8), lits, np.tile(np.uint8([2, 0]), (n, 1))], axis=1)
    five = seqs.tobytes() + bytes([0x10, 0x41])
    lsic = 3000 - 15
    random = bytes([0xF0]) + bytes([255]) * (lsic // 255) + bytes([lsic % 255]) + rng.bytes(3000)
    fail = bytearray(five)
    fail[5 * fail_at + 3] = 0
    comp, sizes = batch([five, random, b"", bytes(fail)], len(five))
    return comp, sizes, 6 * n + 1, 3


def kernel_sizes(rng):
    """Chunks from tiny to 1 MB, one batch per capacity, for the
    kernel-vs-plain comparisons on the card.  The plain versions step one
    sequence at a time, so the largest chunks take the profiles with few
    sequences (long literal runs and long matches)."""
    out = []
    for c, names in ((64, None), (4096, None),
                     (65536, ("runs", "words", "random", "text", "half_dup", "zeros")),
                     (1 << 20, ("random", "text", "half_dup", "repeat256", "zeros"))):
        prof = profiles(rng, c)
        arr, lens = batch([prof[k] for k in (names or prof)], c)
        lens[1] = max(0, c - 7)
        out.append((f"C{c}", arr, lens))
    return out


def big_chunk(rng, c: int = 16 << 20):
    """One 16 MB chunk of random stretches, zero runs, repeats of the
    previous bytes (offsets up to 65535) and text: long literal runs and
    long matches, a few thousand sequences."""
    out = np.zeros(c, np.uint8)
    n = 0
    while n < c:
        kind = int(rng.integers(0, 4))
        size = min(c - n, int(rng.integers(1 << 12, 1 << 18)))
        if kind == 0:
            out[n : n + size] = rng.integers(0, 256, size, dtype=np.uint8)
        elif kind == 1 and n >= 65535:
            off = int(rng.integers(4096, 65536))
            for k in range(0, size, off):  # a copy that may overlap itself
                m = min(off, size - k)
                out[n + k : n + k + m] = out[n + k - off : n + k - off + m]
        elif kind == 2:
            out[n : n + size] = np.frombuffer((b"the quick brown fox jumps over the lazy dog. " * (size // 45 + 1))[:size], np.uint8)
        # kind 3 (and kind 1 near the start): zeros
        n += size
    return batch([out], c)


def window_edge_row(rng, c: int, max_offset: int):
    """(uint8[1, c], int32[1]): random bytes with 16-byte copies from
    exactly ``max_offset`` back (the window's last candidate) and
    ``max_offset + 1`` back (just past it), and short-distance copies,
    planted at and around the 64K boundaries of the card's match-table
    segments (and one copy reaching back across one)."""
    out = rng.integers(0, 256, c, dtype=np.uint8)
    seams = [s for s in range(1 << 16, c, 1 << 16)][:6] + [max_offset + 700, c - 40]
    for s in seams:
        for at, dist in ((s - 2, max_offset), (s + 20, max_offset + 1), (s + 3, 9), (s - 30, 1 << 12)):
            if dist <= at and at + 16 <= c:
                out[at : at + 16] = out[at - dist : at - dist + 16]
    return batch([out], c)


def collision_row(rng, c: int):
    """(uint8[1, c], int32[1]): windows that agree in three of their four
    bytes: every fourth byte random from a small alphabet, the others
    fixed, so each byte of the sort's key must separate them, and equal
    windows recur at many distances."""
    out = np.tile(np.frombuffer(b"\x00ab", np.uint8), c // 3 + 1)[:c].copy()
    out[::4] = rng.integers(0, 6, (c + 3) // 4, dtype=np.uint8)
    return batch([out], c)


def unique_windows(rng, c: int) -> np.ndarray:
    """c random bytes in which no 4-byte window repeats: one literal run,
    and a sort in which every key is distinct."""
    d = rng.integers(0, 256, c, dtype=np.uint8)
    while True:
        w = d[:-3].astype(np.int64) | d[1:-2].astype(np.int64) << 8 | d[2:-1].astype(np.int64) << 16 \
            | d[3:].astype(np.int64) << 24
        _, first, counts = np.unique(w, return_index=True, return_counts=True)
        if (counts == 1).all():
            return d
        d[first[counts > 1]] ^= rng.integers(1, 256, int((counts > 1).sum()), dtype=np.uint8)


def table_rows(rng):
    """(label, uint8[B, C], int32[B]) for the match-table kernel beside
    the encode cases: the window edges of LZ4 at 70 KB and in a 16 MB chunk,
    the collision row, all-distinct windows, and rows of n in {0, 3, 4, 12,
    13, 14} bytes and capacities that are no multiple of 4 or 32."""
    tiny = [rng.integers(0, 3, n).astype(np.uint8) for n in (0, 3, 4, 12, 13, 14)]
    return [("window edge 70 KB", *window_edge_row(rng, 70000, 65535)),
            ("window edge 16 MB", *window_edge_row(rng, 16 << 20, 65535)),
            ("collisions 70 KB", *collision_row(rng, 70001)),
            ("distinct windows 128 KB", *batch([unique_windows(rng, 1 << 17)], 1 << 17)),
            ("tiny rows", *batch(tiny, 14)),
            ("odd capacity", *batch([rng.integers(0, 4, 37).astype(np.uint8), b"abcabcabc" * 4], 37))]


# The grouping path of csrc/lz_match_table.cu (rows of up to 64 KB): its
# hash of a 4-byte window (little-endian) into 2**13 buckets, and the size
# above which a bucket goes through its sorts, the large-bucket path.
GROUP_MAX_ROW = 1 << 16
GROUP_HASH_MUL, GROUP_HASH_BITS = 2654435761, 13
GROUP_SMALL = 32


def group_buckets(keys: np.ndarray) -> np.ndarray:
    """The grouping path's bucket of each uint32 window."""
    return ((keys.astype(np.uint64) * GROUP_HASH_MUL) & 0xFFFFFFFF) >> (32 - GROUP_HASH_BITS)


def one_bucket_row(rng, c: int, stride: int) -> np.ndarray:
    """c bytes whose windows at the multiples of ``stride`` (4 or 2) all
    fall in bucket 0 of the grouping path's hash, mostly distinct: at 4,
    words w with w * MUL < 2**19 (mod 2**32); at 2, 16-bit halves each
    chosen from the 8 that put the window it closes in bucket 0.  (No row
    puts every window at stride 1 in one bucket: a byte has 8 bits of
    freedom and a bucket takes 13.)"""
    if stride == 4:
        inv = pow(GROUP_HASH_MUL, -1, 1 << 32)
        t = rng.choice(1 << (32 - GROUP_HASH_BITS), c // 4 + 1, replace=False).astype(np.uint64)
        return ((t * np.uint64(inv)) & np.uint64(0xFFFFFFFF)).astype("<u4").view(np.uint8)[:c].copy()
    # the window at 2k is h[k] | h[k + 1] << 16; its product's top 16 bits
    # are (h[k] * MUL >> 16) + h[k + 1] * (MUL mod 2**16), mod 2**16
    m16 = GROUP_HASH_MUL & 0xFFFF
    inv16 = pow(m16, -1, 1 << 16)
    top = rng.integers(0, 1 << (16 - GROUP_HASH_BITS), c // 2 + 1)  # a product's top 16 bits below 8: bucket 0
    h = np.zeros(c // 2 + 2, np.int64)
    h[0] = int(rng.integers(0, 1 << 16))
    for k in range(c // 2 + 1):
        hi = (int(h[k]) * GROUP_HASH_MUL >> 16) & 0xFFFF
        h[k + 1] = (int(top[k]) - hi) * inv16 & 0xFFFF
    return h.astype("<u2").view(np.uint8)[:c].copy()


def frequent_window_rows(rng, c: int = 1 << 16):
    """(uint8[3, c], int32[3]): random bytes with words of bucket 0 planted
    at multiples of 4, most of them one frequent word and the rest
    distinct: 300 planted, 60% frequent (a bucket one warp sorts by window
    and position), 1,000 at 60% (too many for a warp: the CTA's bitmap of
    the frequent word's positions, the rest set aside and sorted by a
    warp) and every aligned word at 85% (the rest, ~2,500, sorted by the
    CTA)."""
    inv = pow(GROUP_HASH_MUL, -1, 1 << 32)
    rows = []
    for planted, share in ((300, 0.6), (1000, 0.6), (c // 4, 0.85)):
        row = rng.integers(0, 256, c, dtype=np.uint8)
        at = np.sort(rng.choice(c // 4, planted, replace=False))
        t = rng.choice(np.arange(1, 1 << (32 - GROUP_HASH_BITS)), planted, replace=False).astype(np.uint64)
        t[rng.random(planted) < share] = 0x5A5A
        words = ((t * np.uint64(inv)) & np.uint64(0xFFFFFFFF)).astype("<u4").view(np.uint8).reshape(-1, 4)
        row.reshape(-1, 4)[at] = words
        rows.append(row)
    return batch(rows, c)


def clash_rows(rng, c: int = 1 << 16):
    """(uint8[4, c], int32[4]): random bytes with words planted at multiples
    of 4 whose hashes (GROUP_HASH_MUL) differ in their lowest 3 bits only:
    one bucket and the same bits 3 .. 18, which the grouping path's 32-bit
    sort values cannot tell apart, so it must check and sort such buckets
    again by the windows themselves.  Row 0: 400 such pairs, 3 of each word,
    in buckets of a few; row 1: one pair, 100 of each, in turn (a warp's
    bucket); rows 2 and 3: three such words over every aligned word, 40 / 30
    / 30% (the CTA sorts the whole bucket) and 80 / 10 / 10% (the CTA sorts
    the two minor ones after the bitmap of the major)."""
    inv = pow(GROUP_HASH_MUL, -1, 1 << 32)

    def words(h):
        return ((np.asarray(h, np.uint64) * np.uint64(inv)) & np.uint64(0xFFFFFFFF)).astype("<u4")

    rows = []
    row = rng.integers(0, 256, c, dtype=np.uint8)
    h = rng.choice(1 << 29, 400, replace=False).astype(np.uint64) << np.uint64(3)
    pairs = np.stack([words(h), words(h + np.uint64(1))], 1)
    at = rng.choice(c // 4, 2400, replace=False)
    row.reshape(-1, 4)[at] = np.tile(pairs, 3).reshape(-1).view(np.uint8).reshape(-1, 4)
    rows.append(row)
    row = rng.integers(0, 256, c, dtype=np.uint8)
    at = np.sort(rng.choice(c // 4, 200, replace=False))
    row.reshape(-1, 4)[at] = np.tile(words([0x12345678, 0x12345679]), 100).view(np.uint8).reshape(-1, 4)
    rows.append(row)
    for shares in ((0.4, 0.7), (0.8, 0.9)):
        u = rng.random(c // 4)
        which = np.where(u < shares[0], 0, np.where(u < shares[1], 1, 2))
        rows.append(words(0x3C3C3C38 + which).view(np.uint8).copy())
    return batch(rows, c)


def group_rows(rng):
    """(label, uint8[B, C], int32[B]) for the grouping path of the
    match-table kernel, each to be run at strides 1, 2 and 4: rows of one
    bucket (at stride 4 and 2), a frequent window among distinct ones of
    its bucket, windows its sort values cannot tell apart, zeros, all-distinct windows, the window edge of Snappy
    (32,768 back) and the collision row at 64 KB, and mixed rows of 65,536
    bytes (this path; full, n - 3 and zeros) and 65,537 (the radix path)."""
    c = GROUP_MAX_ROW
    return [("one bucket at stride 4", *batch([one_bucket_row(rng, c, 4)], c)),
            ("one bucket at stride 2", *batch([one_bucket_row(rng, c, 2)], c)),
            ("frequent window in its bucket", *frequent_window_rows(rng, c)),
            ("clashing windows", *clash_rows(rng, c)),
            ("zeros 64 KB", *batch([np.zeros(c, np.uint8)], c)),
            ("distinct windows 64 KB", *batch([unique_windows(rng, c)], c)),
            ("window edge 64 KB", *window_edge_row(rng, c, 32768)),
            ("collisions 64 KB", *collision_row(rng, c)),
            ("mixed 65,536 B", *batch([random_row(rng, c), random_row(rng, c - 3), np.zeros(c, np.uint8)], c)),
            ("mixed 65,537 B", *batch([random_row(rng, c + 1), random_row(rng, 40000)], c + 1))]


def group_counts(arr: np.ndarray, lens: np.ndarray, stride: int) -> tuple[int, int]:
    """The tracer's ``lz.table.positions`` and
    ``lz.table.large_bucket_positions`` for one table of these rows: the
    valid positions of rows of up to 64 KB, and those of them in buckets of
    more than GROUP_SMALL (rows past 64 KB take the radix path, which
    counts nothing)."""
    if arr.shape[1] > GROUP_MAX_ROW:
        return 0, 0
    positions = large = 0
    for row, n in zip(arr, lens):
        n = min(max(int(n), 0), arr.shape[1])
        if n < 4:
            continue
        r = row[:n].astype(np.uint32)
        keys = (r[:-3] | r[1:-2] << 8 | r[2:-1] << 16 | r[3:] << 24)[::stride]
        counts = np.bincount(group_buckets(keys).astype(np.int64), minlength=1 << GROUP_HASH_BITS)
        positions += keys.size
        large += int(counts[counts > GROUP_SMALL].sum())
    return positions, large


def random_row(rng, n: int) -> np.ndarray:
    """n bytes of random segments: runs, random bytes, text, zeros, short
    periods and copies of earlier bytes at offsets near and past 65535."""
    out = np.zeros(n, np.uint8)
    i = 0
    while i < n:
        kind = int(rng.integers(0, 6))
        size = min(n - i, int(rng.integers(1, 1 << int(rng.integers(2, 15)))))
        if kind == 0:
            out[i : i + size] = np.repeat(rng.integers(0, 6, size), rng.integers(1, 12, size))[:size]
        elif kind == 1:
            out[i : i + size] = rng.integers(0, 256, size, dtype=np.uint8)
        elif kind == 2:
            out[i : i + size] = rng.choice(np.frombuffer(b"abcde fghij", np.uint8), size)
        elif kind == 3:
            per = rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8)
            out[i : i + size] = np.tile(per, size // per.size + 1)[:size]
        elif kind == 4 and i > 0:
            off = int(rng.choice([rng.integers(1, 64), rng.integers(1, i + 1), min(i, 65535), min(i, 65536)]))
            for k in range(size):  # byte by byte: the copy may overlap itself
                out[i + k] = out[i + k - off]
        i += size
    return out


def window_rows(rng) -> dict:
    """Rows for the decode kernels' staged window and batched copies:
    matches whose source lies a few elements back (in the same parse
    batch), runs of every period 1-15 at unaligned output offsets, and a
    12 KB row, half of it random, whose stream is longer than the 4 KB
    window."""
    near = []
    for _ in range(250):
        near.append(rng.integers(0, 256, 6, dtype=np.uint8))
        back = int(rng.integers(12, 33))
        flat = np.concatenate(near)
        near.append(flat[flat.size - back : flat.size - back + 6])
    periods = []
    for p in range(1, 16):
        periods.append(rng.integers(0, 256, 17 + p, dtype=np.uint8))
        periods.append(np.tile(rng.integers(0, 256, p, dtype=np.uint8), 80 // p + 1)[:80])
    return {"near_matches": np.concatenate(near), "periods": np.concatenate(periods),
            "long": np.concatenate([rng.integers(0, 256, 6000, dtype=np.uint8), random_row(rng, 6000)])}


def window_cases(rows: dict, compress_oracle):
    """(label, comp uint8[B, CMAX], sizes int32[B], out capacity) for the
    decode kernels: the streams of ``rows`` (``window_rows``) by ``compress_oracle`` in
    rows of an odd CMAX (every row's staging starts unaligned), and the
    long row's stream cut 1-3 bytes short with its full size, so its last
    reads pass the row's end (clamped, or wrapped to its first byte)."""
    streams = [compress_oracle(r.tobytes()) for r in rows.values()]
    cap = max(r.size for r in rows.values())
    odd = max(map(len, streams)) + 9 | 1
    out = [("window, odd CMAX", *batch(streams, odd), cap)]
    s = streams[-1]
    for cut in (1, 2, 3):
        comp, _ = batch([s[: len(s) - cut]], len(s) - cut)
        out.append((f"long row cut by {cut}", comp, np.array([len(s)], np.int32), cap))
    return out


def random_batch(rng, c_max: int = 70000):
    """(uint8[B, C], int32[B], stride): 1-6 rows of ``random_row`` with
    random lengths in [0, C] and a random match stride."""
    c = int(rng.integers(1, c_max))
    rows = [random_row(rng, int(rng.integers(0, c + 1))) for _ in range(int(rng.integers(1, 7)))]
    arr, lens = batch(rows, c)
    return arr, lens, int(rng.choice([1, 1, 2, 4]))


def damage(rng, comp: np.ndarray, sizes: np.ndarray):
    """Copies of streams with random faults: bit flips, byte runs of 255,
    and sizes truncated, zero, negative or past the row."""
    comp, sizes = comp.copy(), sizes.copy()
    cmax = comp.shape[1]
    for i in range(len(sizes)):
        n = max(1, int(sizes[i]))
        kind = int(rng.integers(0, 5))
        if kind == 0:
            for _ in range(int(rng.integers(1, 4))):
                comp[i, int(rng.integers(0, n))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 1:
            at = int(rng.integers(0, n))
            comp[i, at : at + int(rng.integers(1, 600))] = 255
        elif kind == 2:
            sizes[i] = int(rng.integers(0, n + 1))
        elif kind == 3:
            sizes[i] = int(rng.choice([0, -1, cmax, cmax + int(rng.integers(1, 5000))]))
    return comp, sizes
