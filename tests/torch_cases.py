"""Cascaded inputs shared by the port's tests and chip_smoke.py.

numpy only: the same seeded batches go through the JAX package and the
port (tests/test_torch_cascaded.py), and through the port's plain version
and its CUDA kernels (tests/test_torch_kernels.py, chip_smoke.py).  Options
are plain field dicts, so each package builds its own CascadedOpts.

The cases held against the JAX package on the CPU stay at 1-5 partitions
of <= 40 KB; the kernel cases add more random ones and two 16 MB
partitions, which only the card runs.
"""

from __future__ import annotations

import numpy as np

# DataType values
CHAR, UCHAR, SHORT, USHORT, INT, UINT, LONGLONG, ULONGLONG = range(8)


def opts(chunk_size=4096, type=INT, num_rles=2, num_deltas=1, use_bp=True) -> dict:
    return dict(chunk_size=chunk_size, type=type, num_rles=num_rles,
                num_deltas=num_deltas, use_bp=use_bp)


DEFAULT = opts()
WIDTH = {CHAR: 1, UCHAR: 1, SHORT: 2, USHORT: 2, INT: 4, UINT: 4, LONGLONG: 8, ULONGLONG: 8}

# the layer/dtype matrix of tests/test_cascaded_pallas.py (CONFIGS), at its
# small capacities
CONFIGS = [
    (DEFAULT, 16384, "runs"),
    (DEFAULT, 16384, "random"),
    (DEFAULT, 16384, "ramp"),
    (opts(num_rles=2, num_deltas=2), 8192, "ramp"),
    (opts(num_rles=0, num_deltas=1), 8192, "ramp"),
    (opts(num_rles=0, num_deltas=0, use_bp=True), 8192, "runs"),
    (opts(use_bp=False), 8192, "runs"),
    (opts(type=SHORT, chunk_size=4096), 8192, "runs"),
    (opts(type=UCHAR, chunk_size=4096), 8192, "runs"),
    (opts(type=UCHAR, num_rles=1, num_deltas=0, chunk_size=512), 4096, "runs"),
    (DEFAULT, 4096, "runs"),
    (DEFAULT, 2048, "runs"),
    (opts(type=USHORT, use_bp=False, num_rles=1, num_deltas=1, chunk_size=2048), 6144, "runs"),
]


def profile_bytes(rng, name: str, nbytes: int, width: int) -> bytes:
    if name == "runs":
        t = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[width]
        n = nbytes // width + 8
        return (np.repeat(rng.integers(0, 30, n), rng.integers(1, 9, n))
                .astype(t).tobytes()[:nbytes])
    if name == "random":
        return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    if name == "ramp":
        return (np.arange(nbytes // 4 + 1, dtype=np.int32) * 3 + 7).tobytes()[:nbytes]
    if name == "signed":  # small values of both signs, in runs
        t = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[width]
        n = nbytes // width + 8
        return (np.repeat(rng.integers(-100, 100, n), rng.integers(1, 4, n))
                .astype(t).tobytes()[:nbytes])
    if name == "signed64":  # the same as int64 whatever the width
        return profile_bytes(rng, "signed", nbytes, 8)
    raise ValueError(name)


def batch(raw: bytes, b: int, c: int):
    """Consecutive c-byte rows of ``raw`` as (uint8[b, c], int32[b])."""
    arr = np.zeros((b, c), np.uint8)
    lens = np.zeros(b, np.int32)
    for i in range(b):
        a = np.frombuffer(raw[i * c : (i + 1) * c], np.uint8)
        arr[i, : a.size] = a
        lens[i] = a.size
    return arr, lens


def config_case(rng, fields: dict, c: int, profile: str):
    """Three partitions of a profile, the last one ragged."""
    raw = profile_bytes(rng, profile, 3 * c + 17, min(WIDTH[fields["type"]], 4))
    arr, lens = batch(raw, 3, c)
    lens[-1] = max(1, lens[-1] - 37)
    return arr, lens


def barely_compressible(rng, c: int = 16384):
    """Text-like bytes read as int32: big final blobs at bw = 32 and
    all-count-1 second RLE blobs (the profile of
    tests/test_cascaded_pallas.py::test_decode_barely_compressible_chunks)."""
    words = rng.integers(97, 123, (3, c), dtype=np.uint8)
    words[0, rng.integers(0, c, c // 8)] = 32  # spaces -> short runs
    return words, np.array([c, c, c - 4], np.int32)


def compress_cases(seed: int = 0):
    """(label, opts fields, data uint8[B, C], lengths int32[B]) for every
    compress case."""
    rng = np.random.default_rng(seed)
    cases = []
    for i, (fields, c, profile) in enumerate(CONFIGS):
        cases.append((f"config{i}-{profile}", fields, *config_case(rng, fields, c, profile)))
    cases.append(("barely-compressible", DEFAULT, *barely_compressible(rng)))

    # empty, sub-width, non-multiple and tiny lengths
    edge = np.zeros((5, 8192), np.uint8)
    edge[2] = rng.integers(0, 3, 8192)
    edge[3, :8] = 255
    edge[4, :403] = np.frombuffer(np.arange(100, dtype=np.int32).tobytes() + b"\x01\x02\x03", np.uint8)
    cases.append(("edge-lengths", DEFAULT, edge, np.array([0, 3, 8192, 8, 403], np.int32)))

    # capacity not a multiple of the chunk size
    cases.append(("capacity-10000", DEFAULT,
                  *batch(profile_bytes(rng, "runs", 3 * 10000, 4), 3, 10000)))
    # no layers at all: every partition falls back
    cases.append(("no-layers", opts(num_rles=0, num_deltas=0, use_bp=False),
                  *config_case(rng, DEFAULT, 4096, "runs")))
    cases.append(("longlong", opts(type=LONGLONG), *config_case(rng, opts(type=LONGLONG), 4096, "runs")))
    return cases


# the rest of the option space the kernels take: the largest chunk, seven
# layers of each kind, rows whose width is not a multiple of 4, signed data
WIDE_CONFIGS = [
    (opts(type=UCHAR, chunk_size=16384), 16384, "runs"),
    (opts(type=CHAR, chunk_size=1024, num_rles=1, num_deltas=1), 5000, "signed"),
    (opts(num_rles=7, num_deltas=7), 8192, "runs"),
    (opts(num_rles=0, num_deltas=7), 8192, "ramp"),
    (opts(num_rles=3, num_deltas=2, use_bp=False), 8192, "signed"),
    (opts(type=SHORT, chunk_size=2048), 6146, "signed"),
    (DEFAULT, 10001, "runs"),
    (opts(type=UINT, chunk_size=512), 4096, "random"),
    # 8-byte elements: small int64s of both signs, and int32 pairs (64-bit
    # values whose high words are live, bit widths past 32)
    (opts(type=LONGLONG, chunk_size=512, num_rles=7, num_deltas=7), 8192, "signed64"),
    (opts(type=LONGLONG, chunk_size=16384, num_rles=7, num_deltas=7), 40004, "signed"),
    (opts(type=ULONGLONG, chunk_size=512, num_rles=7, num_deltas=7), 6148, "signed"),
    (opts(type=ULONGLONG, chunk_size=16384, num_rles=7, num_deltas=7), 33000, "signed64"),
]


def wide_cases(seed: int = 2):
    """(label, opts fields, data, lengths) for WIDE_CONFIGS."""
    rng = np.random.default_rng(seed)
    return [(f"wide{i}-{profile}", fields, *config_case(rng, fields, c, profile))
            for i, (fields, c, profile) in enumerate(WIDE_CONFIGS)]


def fuzz_cases(seed: int, count: int):
    """Random valid options (all eight element types), shapes, lengths and
    profiles: (label, opts fields, data, lengths)."""
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(count):
        dtype = int(rng.integers(0, 8))
        w = WIDTH[dtype]
        nr = int(rng.integers(0, 8))
        nd = int(rng.integers(0, (nr if nr else 7) + 1))
        chunk = int(rng.choice([512, 1024, 2048, 4096, 8192, 16384]))
        fields = opts(chunk, dtype, nr, nd, bool(rng.integers(0, 2)))
        b = int(rng.integers(1, 5))
        c = int(rng.integers(1, 40000))
        profile = str(rng.choice(["runs", "random", "ramp", "signed"]))
        arr, lens = batch(profile_bytes(rng, profile, b * c, min(w, 4)), b, c)
        lens = np.minimum(lens, rng.integers(0, c + 1, b)).astype(np.int32)
        cases.append((f"fuzz{seed}-{i}", fields, arr, lens))
    return cases


def large_case(seed: int = 3):
    """Two 16 MB partitions (the largest the reference allows), the second
    ragged."""
    rng = np.random.default_rng(seed)
    c = 16 << 20
    arr, lens = batch(profile_bytes(rng, "runs", 2 * c, 4), 2, c)
    lens[1] -= 4099
    return ("16MB-partitions", DEFAULT, arr, lens)


INT64_MIN, INT64_MAX = -(2**63), 2**63 - 1


def w8_cases(seed: int = 4):
    """8-byte profiles, each batch (label, opts fields, data, lengths) of
    4 partitions of 16 KB (four 4 KB scheme chunks), the last ragged:

    - INT64_MIN and INT64_MAX in one chunk among runs (a range that wraps:
      bw = 64), with RLE alone (the run values are the final blob) and
      with the default layers;
    - values above 2**32 (and below -2**32) with small deltas;
    - ULONGLONG values >= 2**63 (negative as signed), some rows crossing
      2**63 to small values;
    - lengths that are not a multiple of 8 and all-equal chunks."""
    rng = np.random.default_rng(seed)
    c, n = 16384, 2048

    def runs(lo, hi):
        return np.repeat(rng.integers(lo, hi, n), rng.integers(1, 12, n))[:n].astype(np.int64)

    def rows(cols, lens=None):
        arr = np.stack([col.view(np.uint8) for col in cols])
        return arr, np.array(lens or [c] * len(cols), np.int32)

    ext = []
    for _ in range(4):
        col = runs(-50, 50)
        col[rng.integers(0, 512)] = INT64_MIN  # both in the first chunk
        col[rng.integers(0, 512)] = INT64_MAX
        ext.append(col)
    ext_rows = rows(ext, [c, c, c, c - 8 * 37 - 5])
    big = [2**40 + np.cumsum(rng.integers(1, 6, n)), -(2**40) - np.cumsum(rng.integers(0, 4, n)),
           1_700_000_000_000_000 + np.repeat(np.cumsum(rng.integers(-3, 4, n)), 3)[:n] * 1000,
           (np.int64(1) << 33) * runs(-3, 4)]
    high = [runs(0, 40) + INT64_MIN, INT64_MIN + np.cumsum(rng.integers(0, 3, n)),
            np.where(np.arange(n) % 700 < 350, INT64_MIN + 5, 7).astype(np.int64), runs(-40, 40)]
    equal = [np.full(n, 0x0123456789ABCDEF, np.int64), np.full(n, -1, np.int64),
             np.concatenate([np.full(1024, 5, np.int64), runs(0, 9)[:1024]]), np.zeros(n, np.int64)]
    return [
        ("w8-int64-extremes-rle", opts(type=LONGLONG, num_rles=1, num_deltas=0), *ext_rows),
        ("w8-int64-extremes", opts(type=LONGLONG), *ext_rows),
        ("w8-above-2^32", opts(type=LONGLONG), *rows(big, [c, c - 3, c - 8, c - 4093])),
        ("w8-ulonglong-high", opts(type=ULONGLONG), *rows(high, [c, c - 1, c, c - 8 * 100 - 7])),
        ("w8-ragged-all-equal", opts(type=ULONGLONG), *rows(equal, [c - 7, 8 * 513 + 3, c, 5])),
    ]


def kernel_cases():
    """Every case the CUDA kernels are held to their plain versions on."""
    return (compress_cases() + wide_cases() + fuzz_cases(0, 48) + w8_cases()
            + [large_case()])


def damage(rng, comp: np.ndarray, sizes: np.ndarray):
    """Random byte flips and random sizes applied to compressed rows."""
    comp = comp.copy()
    sizes = sizes.copy()
    for r in range(comp.shape[0]):
        hits = rng.integers(0, max(1, int(sizes[r])), int(rng.integers(0, 4)))
        comp[r, np.minimum(hits, comp.shape[1] - 1)] ^= rng.integers(1, 256, hits.size, dtype=np.uint8)
        if rng.integers(0, 3) == 0:
            sizes[r] = rng.integers(-4, comp.shape[1] + 16)
    return comp, sizes


def corrupt_cases(comp: np.ndarray, sizes: np.ndarray, seed: int = 1):
    """Damaged versions of one default-opts partition ``comp[0]`` (sizes[0]
    bytes): (label, rows uint8[B, CMAX], comp_sizes int32[B])."""
    rng = np.random.default_rng(seed)
    row, size = comp[0], int(sizes[0])
    rows, szs, labels = [], [], []

    def add(label, r, s):
        labels.append(label)
        rows.append(r)
        szs.append(s)

    add("intact", row, size)
    add("truncated-size", row, max(8, size // 2))
    add("size-minus-4", row, size - 4)
    add("size-3", row, 3)
    add("size-zero", np.zeros_like(row), 0)
    add("size-negative", row, -4)
    garbage = rng.integers(0, 256, row.size, dtype=np.uint8)
    garbage[:8] = row[:8]
    add("garbage-plausible-header", garbage, size)
    z = row.copy()
    z[8:12] = 0  # first chunk's total zeroed
    add("chunk-total-zeroed", z, size)
    f = row.copy()
    f[20:28] ^= 0xFF
    add("flipped-mid-stream", f, size)
    for j in range(8):
        h = row.copy()
        h[j] ^= 0x5A
        add(f"flipped-header-byte{j}", h, size)
    for j in range(4):
        add(f"random-row{j}", rng.integers(0, 256, row.size, dtype=np.uint8),
            int(rng.integers(0, row.size + 16)))
    fb = row.copy()
    fb[0:3] = 0  # claims to be a raw fallback
    add("fake-fallback", fb, size)
    return labels, np.stack(rows), np.array(szs, np.int32)


def corrupt_source(seed: int = 0):
    """The partition the corrupt cases damage: 2000 run-heavy int32s."""
    x = np.repeat(np.arange(100, dtype=np.int32), 20)
    return x.view(np.uint8).reshape(1, -1).copy(), np.array([x.nbytes], np.int32)
