"""Worst-case output sizing and alignment helpers (host math, no device work).

The reference's sizing contracts, so buffers produced by either package
fit the other's bounds:

  - LZ4 worst case: n + 1 + ceil(n/255), rounded up to 8
  - Snappy worst case: 32 + n + n/6
  - Cascaded worst case: roundUpTo(n, 4) + 8, and the output row the
    codec and its kernels allocate for a partition (``partition_output_max``)
"""

from __future__ import annotations

from tpucomp_torch.core.types import width_of

PARTITION_HEADER = 8  # a Cascaded partition's header bytes


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


def partition_output_max(capacity_bytes: int, opts) -> int:
    """Output buffer bytes per Cascaded partition of ``capacity_bytes``
    bytes under ``opts`` (a ``CascadedOpts``).

    The fallback rule caps every emitted partition at roundUp4(n) + 8
    bytes.  For w == 8 the final chunk's element-width trailing pad can push
    a non-fallback partition up to 4 bytes past the cap (the fallback check
    tracks blob ends, not the trailing pad), hence the slack word.
    """
    w = width_of(opts.type)
    slack = 4 if w == 8 else 0
    return round_up_to(PARTITION_HEADER + round_up_to(capacity_bytes, 4) + slack, max(4, w))


# Valid uncompressed chunk-size ranges (reference include/hipcomp/lz4.h:67-74,
# include/hipcomp/cascaded.h:92-100).
LZ4_MIN_CHUNK = 32 * 1024
LZ4_MAX_CHUNK = 16 * 1024 * 1024
LZ4_RECOMMENDED_CHUNK = 64 * 1024
CASCADED_MIN_CHUNK = 512
CASCADED_MAX_CHUNK = 16384
CASCADED_RECOMMENDED_CHUNK = 4096
