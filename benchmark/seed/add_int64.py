"""Every int64 element plus one constant k drawn from the seed, 1 <= k <
2**40, wrapping as uint64: runs and deltas of 8-byte elements stay as they
are, only the first values and the frames of reference move.  Below 2**40
the constant keeps a column of values near 1.7e15 (microsecond
timestamps) far from 2**63, so the signed frames keep their bit widths."""

import numpy as np


def apply(raw: bytes, seed: int) -> bytes:
    k = int(np.random.default_rng(seed).integers(1, 2**40))
    return (np.frombuffer(raw, np.uint64) + np.uint64(k)).tobytes()
