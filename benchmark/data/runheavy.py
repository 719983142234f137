"""Run-heavy int32 columns, drawn from the seed.

A frozen copy of ``tpucomp_torch.utils.corpus.runheavy_corpus``: runs of
4 to 47 equal values that drift by -3..3 from run to run, around 1000.
Every seed gives the same kind of column, so the work per call does not
depend on it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def make(total_bytes: int, seed: int, root: Path, params: dict) -> bytes:
    rng = np.random.default_rng(seed)
    n = total_bytes // 4
    n_runs = n // 16 + 2
    runlens = rng.integers(4, 48, size=n_runs)
    vals = np.cumsum(rng.integers(-3, 4, size=n_runs)).astype(np.int32) + 1000
    col = np.repeat(vals, runlens)[:n].astype(np.int32)
    if col.size < n:
        col = np.pad(col, (0, n - col.size), mode="edge")
    return col.tobytes()[:total_bytes]
