"""Inputs of the batch-API conformance matrix, without jax.

The payload generator of ``tests/test_batch_api.py`` (``_payloads``; the
same draws from the same generator give the same chunks, which
``tests/test_torch_batch_api.py`` checks), and its garbage batch, for
``tests/test_torch_batch_api.py`` on the CPU and ``chip_smoke.py``
phase 20 on the card, which imports no jax.
"""

import numpy as np

# the reference matrix's batch sizes (tests/test_batch_c_api.h:749-775);
# tpucomp runs 1, 11 and 127, and 1025 as a slow row
BATCH_SIZES = [1, 11, 127, 1025, 10025]
CAPACITY = 2048
GARBAGE_ROWS = 16


def payloads(rng, codec_name, batch_size, capacity=CAPACITY):
    """Random compressible chunks with random sizes in [64, capacity]
    (whole int32 elements for Cascaded): runs of 1 to 5 equal bytes of
    value 0 to 29."""
    out = []
    for _ in range(batch_size):
        n = int(rng.integers(64, capacity + 1))
        if codec_name == "cascaded":
            n = n // 4 * 4  # whole int32 elements
        vals = rng.integers(0, 30, n)
        reps = rng.integers(1, 6, n)
        chunk = np.repeat(vals, reps)[:n].astype(np.uint8)
        out.append(chunk.tobytes())
    return out


def garbage(rng, rows=GARBAGE_ROWS, capacity=CAPACITY):
    """(uint8[rows, capacity] random bytes, int32[rows] sizes in [1,
    capacity)), as tests/test_batch_api.py's crash-safety test draws them."""
    data = rng.integers(0, 256, size=(rows, capacity), dtype=np.uint8)
    sizes = rng.integers(1, capacity, size=rows).astype(np.int32)
    return data, sizes
