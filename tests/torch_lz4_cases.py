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
