"""Core value types: element dtypes and per-chunk status codes.

PyTorch counterpart of ``tpucomp.core.types``.  Enum *values* are the
reference's (hipcompType_t, hipcompStatus_t), so the dtype byte in a
Cascaded partition header means the same thing in both packages.
"""

from __future__ import annotations

import enum

import torch


class DataType(enum.IntEnum):
    """Element type of a chunk, as stored in format metadata."""

    CHAR = 0        # int8
    UCHAR = 1       # uint8
    SHORT = 2       # int16
    USHORT = 3      # uint16
    INT = 4         # int32
    UINT = 5        # uint32
    LONGLONG = 6    # int64
    ULONGLONG = 7   # uint64
    BITS = 0xFF     # single bits (used by BitComp only; unsupported here)


class Status(enum.IntEnum):
    """Per-chunk / per-call status codes."""

    SUCCESS = 0
    ERROR_INVALID_VALUE = 10
    ERROR_NOT_SUPPORTED = 11
    ERROR_CANNOT_DECOMPRESS = 12
    ERROR_BACKEND = 1000
    ERROR_INTERNAL = 10000


_WIDTH = {
    DataType.CHAR: 1,
    DataType.UCHAR: 1,
    DataType.SHORT: 2,
    DataType.USHORT: 2,
    DataType.INT: 4,
    DataType.UINT: 4,
    DataType.LONGLONG: 8,
    DataType.ULONGLONG: 8,
}

# torch has no arithmetic on uint16/32/64, so the port computes on the
# signed type of each width (or int64, see utils/bits.py); only views use
# the unsigned ones.
SIGNED_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def width_of(dtype: DataType) -> int:
    """Element width in bytes."""
    return _WIDTH[DataType(dtype)]
