"""Worst-case output sizing and alignment helpers (host math, no device work).

The reference's sizing contracts, so buffers produced by either package
fit the other's bounds:

  - LZ4 worst case: n + 1 + ceil(n/255), rounded up to 8
  - Snappy worst case: 32 + n + n/6
  - Cascaded worst case: roundUpTo(n, 4) + 8
"""

from __future__ import annotations


def round_up_div(x: int, y: int) -> int:
    return (x + y - 1) // y


def round_up_to(x: int, y: int) -> int:
    return round_up_div(x, y) * y


def round_down_to(x: int, y: int) -> int:
    return (x // y) * y


def lz4_max_compressed_chunk_size(chunk_bytes: int) -> int:
    """Worst-case LZ4 output for a chunk of ``chunk_bytes`` bytes."""
    expansion = chunk_bytes + 1 + round_up_div(chunk_bytes, 255)
    return round_up_to(expansion, 8)


def snappy_max_compressed_chunk_size(chunk_bytes: int) -> int:
    """Worst-case Snappy output for a chunk of ``chunk_bytes`` bytes."""
    return 32 + chunk_bytes + chunk_bytes // 6


def cascaded_max_compressed_chunk_size(chunk_bytes: int) -> int:
    """Worst-case Cascaded output for a partition of ``chunk_bytes`` bytes."""
    return round_up_to(chunk_bytes, 4) + 8


# Valid uncompressed chunk-size ranges (reference include/hipcomp/lz4.h:67-74,
# include/hipcomp/cascaded.h:92-100).
LZ4_MIN_CHUNK = 32 * 1024
LZ4_MAX_CHUNK = 16 * 1024 * 1024
LZ4_RECOMMENDED_CHUNK = 64 * 1024
CASCADED_MIN_CHUNK = 512
CASCADED_MAX_CHUNK = 16384
CASCADED_RECOMMENDED_CHUNK = 4096
