"""Every int32 element plus one constant drawn from the seed, wrapping:
runs and deltas of 4-byte elements stay as they are, only the frames of
reference move.  (On 8-byte elements it would break the carry between
their halves: such data takes a transform of its own width.)"""

import numpy as np


def apply(raw: bytes, seed: int) -> bytes:
    k = int(np.random.default_rng(seed).integers(1, 2**32))
    return (np.frombuffer(raw, np.uint32) + np.uint32(k)).tobytes()
