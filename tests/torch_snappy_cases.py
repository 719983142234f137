"""Snappy inputs shared by the port's tests and chip_smoke.py.

numpy and the pure-Python oracle only: the same seeded batches go through
the JAX package and the port (tests/test_torch_snappy.py), and through the
port's plain versions and its CUDA kernels
(tests/test_torch_snappy_kernels.py, chip_smoke.py).  Each function
returns dense numpy batches.

The cases held against the JAX package on the CPU stay at C = 2048 (one
row at 64 KB); the kernel cases add chunks up to 1 MB and one of 16 MB,
which only the card runs.
"""

from __future__ import annotations

import json
import os

import numpy as np

from oracles.snappy_oracle import snappy_compress_oracle
from torch_lz4_cases import batch, damage, profiles, random_row
from tpucomp_torch.core.sizing import snappy_max_compressed_chunk_size as snappy_max

C = 2048  # the capacity of the cases held against the JAX package
CMAX = snappy_max(C)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "snappy_golden.json")


def varint(n: int) -> bytes:
    out = bytearray()
    while n >= 128:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    return bytes(out + bytes([n]))


def literal(data: bytes) -> bytes:
    """A literal element: the shortest header (tests/oracles/snappy_oracle.py)."""
    v = len(data) - 1
    if v < 60:
        return bytes([v << 2]) + data
    k = (v.bit_length() + 7) // 8
    return bytes([(59 + k) << 2]) + v.to_bytes(k, "little") + data


def edge_rows(rng) -> dict:
    """Tiny and empty rows, literal runs at the header-size edges, matches
    at the copy-split edges (64-68, 100, 1000: copy2(64) runs and the
    copy2(60) that keeps the remainder >= 4) and copy1 territory (short
    matches at offsets < 2048) (tests/test_snappy_pallas.py)."""
    rows = {f"small{n}": rng.integers(0, 4, n).astype(np.uint8) for n in (0, 1, 4, 5, 11, 60, 61, 64)}
    for ll in (60, 61, 256, 257):
        rows[f"lit{ll}"] = np.concatenate([rng.integers(0, 256, ll, dtype=np.uint8), np.zeros(16, np.uint8)])
    for ml in (63, 64, 65, 66, 67, 68, 100, 1000):
        rows[f"match{ml}"] = np.concatenate([np.full(1 + ml, 7, np.uint8),
                                             rng.integers(8, 256, 40, dtype=np.uint8)])
    rows["copy1"] = np.frombuffer(b"abcd" * 6 + b"XYZW" * 16 + b"0123456789ab" * 20, np.uint8)
    far = rng.integers(0, 256, 1500, dtype=np.uint8)
    rows["copy1_far"] = np.concatenate([far, far[:9], rng.integers(0, 256, 300, dtype=np.uint8), far[100:111]])
    return rows


def compress_rows(rng, c: int = C):
    """(names, uint8[B, c], int32[B]): the profiles and the edge rows."""
    rows = {**profiles(rng, c), **edge_rows(rng)}
    arr, lens = batch(list(rows.values()), c)
    return list(rows), arr, lens


def window_row():
    """tests/test_snappy.py::test_merged_table_boundary_matches: a match at
    distance exactly 32768 and matches at positions past 32768, in a 64 KB
    chunk."""
    rng = np.random.default_rng(9)
    base = rng.integers(1, 255, 65536, dtype=np.uint8)
    base[32768 : 32768 + 24] = base[0:24]
    base[50000:50032] = base[45000:45032]
    base[60000:60040] = base[60000 - 32769 : 60000 - 32769 + 40]  # one byte past the window
    return batch([base], 65536)


def unique_windows(rng, c: int) -> np.ndarray:
    """c random bytes in which no 4-byte window repeats: one literal run."""
    d = rng.integers(0, 256, c, dtype=np.uint8)
    while True:
        w = d[:-3].astype(np.int64) | d[1:-2].astype(np.int64) << 8 | d[2:-1].astype(np.int64) << 16 \
            | d[3:].astype(np.int64) << 24
        _, first, counts = np.unique(w, return_index=True, return_counts=True)
        if (counts == 1).all():
            return d
        d[first[counts > 1]] ^= rng.integers(1, 256, int((counts > 1).sum()), dtype=np.uint8)


def large_rows(rng):
    """Rows past 64 KB: a 128 KB literal (the 4-byte literal header) and a
    128 KB match (a long copy2(64) run)."""
    c = 1 << 17
    return batch([unique_windows(rng, c), np.zeros(c, np.uint8)], c)


def golden_streams():
    """(names, comp uint8[B, CMAX], sizes int32[B], expected outputs) of
    tests/fixtures/snappy_golden.json."""
    with open(FIXTURES) as f:
        cases = json.load(f)
    names = sorted(cases)
    streams = [bytes.fromhex(cases[k]["stream"]) for k in names]
    outs = [bytes.fromhex(cases[k]["out"]) for k in names]
    comp, sizes = batch(streams, max(map(len, streams)) + 8)
    return names, comp, sizes, outs


def oracle_streams(arr, lens, cmax: int):
    """The oracle's stream of every row."""
    return batch([snappy_compress_oracle(arr[i, : lens[i]].tobytes()) for i in range(len(lens))], cmax)


def foreign_streams(rng):
    """Valid streams with elements the encoder never emits (tests/
    test_snappy.py::test_decode_foreign_streams, test_snappy_pallas.py::
    test_large_tokens_and_tiny): literal tags 60-63 (1-4 length bytes),
    copy1 at offsets up to 2047, copy4, self-overlapping copies, a 1-byte
    and an empty output.  Returns (labels, comp uint8[B, CMAX], sizes
    int32[B], expected outputs)."""
    lit = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    cases = {}
    for tag, k in ((60, 1), (61, 2), (62, 3), (63, 4)):
        n = 70 + 50 * k
        cases[f"lit_tag{tag}"] = (bytes([tag << 2]) + (n - 1).to_bytes(k, "little") + lit[:n], lit[:n])
    s = literal(lit[:2100]) + bytes([1 | (7 << 2) | (7 << 5), 0xFF])  # copy1 len 11 off 2047
    cases["copy1_off2047"] = (s, lit[:2100] + lit[53:64])
    s = literal(b"abcd") + bytes([1, 4])  # copy1 len 4 off 4
    cases["copy1"] = (s, b"abcdabcd")
    s = literal(lit[:300]) + bytes([3 | (47 << 2)]) + (200).to_bytes(4, "little")  # copy4 len 48 off 200
    cases["copy4"] = (s, lit[:300] + lit[100:148])
    s = literal(b"xyz") + bytes([3 | (63 << 2)]) + (3).to_bytes(4, "little")  # copy4 len 64 off 3, overlapping
    cases["copy4_overlap"] = (s, (b"xyz" * 23)[:67])
    s = literal(b"x") + bytes([((7 - 1) << 2) | 2]) + (1).to_bytes(2, "little")
    cases["copy2_run"] = (s, b"x" * 8)
    cases["one_byte"] = (bytes([0]) + b"Q", b"Q")
    cases["empty"] = (b"", b"")
    labels = list(cases)
    streams = [varint(len(out)) + s for s, out in cases.values()]
    comp, sizes = batch(streams, max(map(len, streams)) + 8)
    return labels, comp, sizes, [out for _, out in cases.values()]


def crafted_streams():
    """Streams on the JAX decoder's edges, in three batches: the walks of
    ``wrap`` and ``s_max`` depend on where their rows end, so each has a
    row of its own, as long as its stream; the rest share one.  Returns
    [(labels, comp uint8[B, CMAX], sizes int32[B])]; decode them at
    ``CRAFTED_CAP``.  ``CRAFTED_EXPECT`` holds each one's (status, length).

    - ``wrap``: the row ends at a copy1 tag; its offset byte lies past the
      row, and the JAX path reads it from the row's first byte (the size
      passes the row), so the stream decodes;
    - ``s_max``: a 62-byte row read past its end (the tag clamped to the
      last byte, a 1-byte literal) up to 36 elements, 3 past the s_max =
      33 the JAX loop records;
    - ``zero_literal``: a literal with the 4-byte length field FF FF FF FF
      (length 0 after the int32 wrap), accepted;
    - ``negative_literal``: FE FF FF FF, length -1: the output position
      moves back one byte and the step advances 4 bytes; accepted;
    - ``negative_literal_copy4``: FD FF FF FF, length -2, lands on a copy4
      element read from the field's own bytes; accepted;
    - ``negative_literal_overlap``: the same after a 1-byte literal 'Z' at
      300, so the copy4 starts at 299, before the 'Z'.  The JAX path
      resolves each output byte by the element with the largest start at
      or before it, so bytes 300-362 are 'Z' and its run; the CUDA kernel
      writes in stream order, so the copy overwrites them (the one known
      divergence, ``kernel_data``);
    - ``big_literal``: a 4-byte length field of 2**31 - 2, whose sums wrap;
    - ``copy4_negative_offset``: an offset with its top bit set;
    - ``varint4``: a varint of 4 bytes whose last has its continuation
      bit set (the JAX path reads 4 bytes and ignores it);
    - ``varint_only``: a 3-byte varint of 0 and nothing else;
    - ``offset_zero`` / ``offset_past_output``: copy2 offsets 0 and o + 1;
    - ``truncated_literal``: a literal past comp_len;
    - ``length_mismatch``: a valid walk whose output differs from the
      varint."""
    lit = np.random.default_rng(17).integers(0, 256, 400, dtype=np.uint8).tobytes()
    body = varint(300) + literal(lit[:292])
    wrap = body + bytes([1 | (4 << 2)])  # copy1 len 8, its offset byte read from row[0]
    s_max = varint(123) + literal(b"A") + bytes([1, 1]) * 29 + bytes([0])
    edge = {
        "zero_literal": varint(8) + literal(b"abcd") + bytes([0xFC, 0xFF, 0xFF, 0xFF, 0xFF, 1, 4]),
        "negative_literal": varint(2) + literal(b"abc") + bytes([0xFC, 0xFE, 0xFF, 0xFF, 0xFF]),
        "negative_literal_copy4": varint(362) + literal(lit[:300]) + bytes([0xFC, 0xFD, 0xFF, 0xFF, 0xFF, 0, 0, 0]),
        "negative_literal_overlap": varint(363) + literal(lit[:300]) + literal(b"Z")
        + bytes([0xFC, 0xFD, 0xFF, 0xFF, 0xFF, 0, 0, 0]),
        "big_literal": varint(8) + literal(b"abcd") + bytes([0xFC, 0xFE, 0xFF, 0xFF, 0x7F]) + b"wxyz",
        "copy4_negative_offset": varint(8) + literal(b"abcd") + bytes([3 | (3 << 2), 4, 0, 0, 0x80]),
        "varint4": bytes([0x85, 0x80, 0x80, 0x80]) + literal(b"hello"),
        "varint_only": bytes([0x80, 0x80, 0x00]),
        "offset_zero": varint(8) + literal(b"abcd") + bytes([(3 << 2) | 2, 0, 0]),
        "offset_past_output": varint(8) + literal(b"abcd") + bytes([(3 << 2) | 2, 5, 0]),
        "truncated_literal": varint(20) + literal(lit[:20]),
        "length_mismatch": varint(9) + literal(b"abcd") + bytes([1, 4]),
    }
    sizes = {k: len(v) for k, v in edge.items()}
    sizes["negative_literal"] -= 1  # the walk ends one byte early
    sizes["truncated_literal"] -= 3
    comp, _ = batch(list(edge.values()), max(map(len, edge.values())) + 8)
    return [
        (["wrap"], batch([wrap], len(wrap))[0], np.array([len(wrap) + 1], np.int32)),
        (["s_max"], batch([s_max], len(s_max))[0], np.array([73], np.int32)),
        (list(edge), comp, np.array(list(sizes.values()), np.int32)),
    ]


CRAFTED_CAP = 1024
OK, BAD = 0, 12
CRAFTED_EXPECT = {
    "wrap": (OK, 300), "s_max": (OK, 123), "zero_literal": (OK, 8), "negative_literal": (OK, 2),
    "negative_literal_copy4": (OK, 362), "negative_literal_overlap": (OK, 363), "big_literal": (BAD, 0), "copy4_negative_offset": (BAD, 0), "varint4": (OK, 5),
    "varint_only": (OK, 0), "offset_zero": (BAD, 0), "offset_past_output": (BAD, 0),
    "truncated_literal": (BAD, 0), "length_mismatch": (BAD, 0),
}



def kernel_data():
    """{label: output} where the CUDA kernel's data differs from the JAX
    path's: the stream-order result of ``negative_literal_overlap``."""
    lit = np.random.default_rng(17).integers(0, 256, 400, dtype=np.uint8).tobytes()
    out = bytearray(lit[:300] + b"Z")
    out[299:] = lit[44:108]  # copy4 of 64 at offset 255 from 299
    return {"negative_literal_overlap": bytes(out)}


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
            v = snappy_compress_oracle(rng.integers(0, 64, cap, dtype=np.uint8).tobytes())
            n = min(len(v), cmax)
            comps[i, :n] = np.frombuffer(v[:n], np.uint8)
            if kind == 1:
                sizes[i] = max(1, n // int(rng.integers(2, 5)))  # truncation
            else:
                k = int(rng.integers(0, max(1, n - 1)))
                comps[i, k] ^= 1 << int(rng.integers(0, 8))  # bit flip
                sizes[i] = n
    return comps, sizes


def kernel_sizes(rng):
    """Chunks from tiny to 1 MB, one batch per capacity, for the
    kernel-vs-plain comparisons on the card.  The plain decoder steps one
    element at a time and a long match is one element per 64 bytes, so
    the 1 MB chunks take three profiles (up to 16K elements)."""
    out = []
    for c, names in ((64, None), (4096, None),
                     (65536, ("runs", "words", "random", "text", "half_dup", "zeros")),
                     (1 << 20, ("random", "text", "half_dup"))):
        prof = profiles(rng, c)
        arr, lens = batch([prof[k] for k in (names or prof)], c)
        lens[1] = max(0, c - 7)
        out.append((f"C{c}", arr, lens))
    return out


def big_chunk(rng, c: int = 16 << 20):
    """One 16 MB chunk: random stretches of 4-256 KB (literals with 3- and
    4-byte headers) between copies of 100-2000 earlier bytes at offsets up
    to 32768.  A few thousand elements, so the plain decoder's
    one-element steps stay few."""
    out = np.empty(c, np.uint8)
    n = 0
    while n < c:
        size = min(c - n, int(rng.integers(1 << 12, 1 << 18)))
        out[n : n + size] = rng.integers(0, 256, size, dtype=np.uint8)
        n += size
        m = min(c - n, int(rng.integers(100, 2000)))
        off = int(rng.integers(m, min(n, 32768) + 1))
        out[n : n + m] = out[n - off : n - off + m]
        n += m
    return batch([out], c)


def random_batch(rng, c_max: int = 70000):
    """(uint8[B, C], int32[B]): 1-6 rows of ``random_row`` with random
    lengths in [0, C]."""
    c = int(rng.integers(1, c_max))
    rows = [random_row(rng, int(rng.integers(0, c + 1))) for _ in range(int(rng.integers(1, 7)))]
    return batch(rows, c)
