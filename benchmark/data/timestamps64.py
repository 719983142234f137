"""An int64 event-time column in microseconds, drawn from the seed.

A frozen copy of ``tpucomp_torch.utils.corpus.timestamps64_corpus``:
strictly increasing values from 1.7e15 us (a time in 2023), in steps of
900 to 1100 us, one event about every millisecond from one source.  Every
value is distinct, so Cascaded's RLE finds runs of one and Delta with
bit-packing carries the column.  Every seed gives the same kind of
column, so the work per call does not depend on it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

BASE = 1_700_000_000_000_000  # microseconds since 1970


def make(total_bytes: int, seed: int, root: Path, params: dict) -> bytes:
    rng = np.random.default_rng(seed)
    n = -(-total_bytes // 8)
    col = BASE + np.cumsum(rng.integers(900, 1101, size=n))
    return col.astype(np.int64).tobytes()[:total_bytes]
