"""The port's measurement corpora: the mixed corpus, the run-heavy columns
and two 64-bit columns.

``chip_smoke.py`` and the A/B scripts under ``scripts/`` time the kernels
on these.  ``load_corpus`` and ``runheavy_corpus`` return the same bytes
as the JAX package's bench loaders of the same names (``bench.py``), with
one difference: a missing ``corpus/mixed_v1.bin.gz`` raises instead of
giving way to a synthetic corpus, so a timing can never be taken on other
data than it names.  ``runheavy64_corpus`` and ``timestamps64_corpus``
are the port's own, for the 8-byte Cascaded types (LONGLONG /
ULONGLONG): int64 columns whose high words are live.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

MIXED = Path(__file__).resolve().parents[2] / "corpus" / "mixed_v1.bin.gz"


def load_corpus(total_bytes: int, seed: int = 0) -> bytes:
    """``corpus/mixed_v1.bin.gz`` (a committed Silesia-profile mix of text,
    source, an ELF binary, structured records, redundant database text and
    near-random bytes, built by ``scripts/build_corpus.py``), rotated by a
    seed-dependent offset when ``seed`` is not 0, repeated to
    ``total_bytes``."""
    if not MIXED.exists():
        raise FileNotFoundError(f"the mixed corpus {MIXED} is missing")
    with gzip.open(MIXED, "rb") as f:
        blob = f.read()
    if seed:
        k = (seed * 1009001) % len(blob)
        blob = blob[k:] + blob[:k]
    reps = -(-total_bytes // len(blob))
    return (blob * reps)[:total_bytes]


def runheavy_corpus(total_bytes: int, seed: int = 2) -> bytes:
    """Deterministic run-heavy int32 columns: runs of 4 to 47 equal values
    that drift by -3..3 from run to run, where the Cascaded pipeline
    compresses every chunk."""
    rng = np.random.default_rng(seed)
    n = total_bytes // 4
    n_runs = n // 16 + 2
    runlens = rng.integers(4, 48, size=n_runs)
    vals = np.cumsum(rng.integers(-3, 4, size=n_runs)).astype(np.int32) + 1000
    col = np.repeat(vals, runlens)[:n].astype(np.int32)
    if col.size < n:
        col = np.pad(col, (0, n - col.size), mode="edge")
    return col.tobytes()[:total_bytes]


BASE64 = 1_700_000_000_000_000  # microseconds since 1970: a time in 2023


def runheavy64_corpus(total_bytes: int, seed: int = 2) -> bytes:
    """``runheavy_corpus``'s runs (4 to 47 equal values, drifting by -3..3
    from run to run) as int64 at ``BASE64 + 1000 * drift``."""
    rng = np.random.default_rng(seed)
    n = total_bytes // 8
    n_runs = n // 16 + 2
    runlens = rng.integers(4, 48, size=n_runs)
    vals = BASE64 + 1000 * np.cumsum(rng.integers(-3, 4, size=n_runs))
    col = np.repeat(vals, runlens)[:n].astype(np.int64)
    if col.size < n:
        col = np.pad(col, (0, n - col.size), mode="edge")
    return col.tobytes()[:total_bytes]


def timestamps64_corpus(total_bytes: int, seed: int = 3) -> bytes:
    """Strictly increasing int64 timestamps in microseconds from ``BASE64``, steps of 900
    to 1100: every value distinct, so RLE finds nothing and Delta with
    bit-packing carries the column."""
    rng = np.random.default_rng(seed)
    n = -(-total_bytes // 8)
    col = BASE64 + np.cumsum(rng.integers(900, 1101, size=n))
    return col.astype(np.int64).tobytes()[:total_bytes]
