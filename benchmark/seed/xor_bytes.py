"""Every byte XOR one byte drawn from the seed: byte equality, and so an
LZ parse, its sequences and sizes, stay as they are."""

import numpy as np


def apply(raw: bytes, seed: int) -> bytes:
    k = int(np.random.default_rng(seed).integers(1, 256))
    return (np.frombuffer(raw, np.uint8) ^ np.uint8(k)).tobytes()
